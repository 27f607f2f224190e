"""What the Brakedown commit cells' readers share: the stages of the
program's ``brakedown_commit-k`` roots and the root's stretch outside them (plonkish_tpu_torch/pcs/brakedown.py,
through ``spans.requests``), and the device time of one kernel's launches in
the profiled commits.  A program without those roots or kernels gives None,
and the metric is left out of the line."""

from __future__ import annotations

from typing import Optional, Sequence

from . import spans


def stage_ms(ctx, stages: Sequence[str]) -> Optional[float]:
    """Milliseconds a commit of the card's stretch of the root's children
    ``<stage>-k``, summed over `stages` (each from its first event to its
    last, the card's idle time inside included), over the untraced commits
    whose stages were all resolved."""
    k = ctx.config["k"]
    req = spans.requests(ctx, f"brakedown_commit-{k}")
    if req is None:
        return None
    names = {f"{stage}-{k}" for stage in stages}
    total, n = 0.0, 0
    for root in req.roots:
        kids = [r for r in req.children.get(root.id, []) if r.name in names]
        if {r.name for r in kids} == names and all(r.device is not None for r in kids):
            total += sum(r.device[1] - r.device[0] for r in kids)
            n += 1
    return 1e3 * total / n if n else None


def gap_ms(ctx) -> Optional[float]:
    """Milliseconds a commit of the root's stretch on the card that lies in
    none of its stages, over the untraced commits whose root and stages were
    all resolved."""
    k = ctx.config["k"]
    req = spans.requests(ctx, f"brakedown_commit-{k}")
    if req is None:
        return None
    total, n = 0.0, 0
    for root in req.roots:
        kids = req.children.get(root.id, [])
        if root.device is None or not kids or any(r.device is None for r in kids):
            continue
        lo, hi = root.device
        total += (hi - lo) - spans._covered([(max(a, lo), min(b, hi)) for a, b in
                                             (r.device for r in kids)])
        n += 1
    return 1e3 * total / n if n else None


def roofline_pct(ctx, kernel: str, least_s: float) -> Optional[float]:
    """`least_s` a commit over the profiled commits, as a share of the device
    time of the operations whose name holds `kernel`.  The profile holds the
    profiled requests alone (it opens with the first and closes after the
    last), and only commits launch the kernel, so every such operation is
    counted: matching them to the requests' host windows would drop the first
    ones, which the profiler's clock mark places a few hundred microseconds
    early (PERF.md, Open questions)."""
    if ctx.device is None:
        return None
    device_s = sum(e - s for name, s, e in ctx.device.ops if kernel in name)
    if device_s <= 0:
        return None
    return 100.0 * ctx.traced * least_s / device_s
