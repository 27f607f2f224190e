"""The program's span records (``plonkish_tpu_torch/utils/timer.py``
``records()``: ids, parents, host start and end, the thread's CPU time and
faults, and for the stages, which do not synchronise, their stretch on the
card, idle time included, in seconds from the request's first event there)
of the requests the profiler did not record, for the readers under
``metrics/``.

Each reader takes the root spans of one kind (``kzg_commit-k``,
``hyperplonk_prove-k``) whose host start lies in ``ctx.untraced_windows()``.
A program without ``records()`` gives None, and so does a run whose roots
carry no device stretch (the CPU): the metric is then left out of the line.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class Requests:
    """The untraced requests' root records, and every record by parent."""

    def __init__(self, roots, recs):
        self.roots = roots
        self.children: Dict[int, list] = defaultdict(list)
        for r in recs:
            if r.parent is not None:
                self.children[r.parent].append(r)


def requests(ctx, root_name: str) -> Optional[Requests]:
    """The records of the untraced requests whose root is named
    `root_name` exactly, or None where there are none to read."""
    from plonkish_tpu_torch.utils import timer

    read = getattr(timer, "records", None)
    if read is None:
        return None
    recs = read()
    wins = ctx.untraced_windows()
    roots = [r for r in recs if r.parent is None and r.name == root_name
             and any(a <= r.start < b for a, b in wins)]
    return Requests(roots, recs) if roots else None


def _stretch(rec) -> Optional[float]:
    return None if rec.device is None else rec.device[1] - rec.device[0]


def commit_stage_ms(ctx, stage: str) -> Optional[float]:
    """Milliseconds a commit of the card's stretch of the root's child
    ``<stage>-k`` (from its first event to its last, the card's idle time
    between them included), over the untraced commits whose stages were
    resolved."""
    k = ctx.config["k"]
    req = requests(ctx, f"kzg_commit-{k}")
    if req is None:
        return None
    total, n = 0.0, 0
    for root in req.roots:
        kids = [r for r in req.children.get(root.id, []) if r.name == f"{stage}-{k}"]
        stretches = [_stretch(r) for r in kids]
        if kids and None not in stretches:
            total += sum(stretches)
            n += 1
    return 1e3 * total / n if n else None


def commit_gap_ms(ctx) -> Optional[float]:
    """Milliseconds a commit of the root's stretch on the card that lies in
    none of its stages."""
    k = ctx.config["k"]
    req = requests(ctx, f"kzg_commit-{k}")
    if req is None:
        return None
    total, n = 0.0, 0
    for root in req.roots:
        kids = req.children.get(root.id, [])
        if root.device is None or not kids or any(r.device is None for r in kids):
            continue
        lo, hi = root.device
        total += (hi - lo) - _covered([(max(a, lo), min(b, hi)) for a, b in
                                       (r.device for r in kids)])
        n += 1
    return 1e3 * total / n if n else None


def _covered(intervals: List[Tuple[float, float]]) -> float:
    out, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        a = max(a, end)
        if b > a:
            out += b - a
            end = b
    return out


def per_prove(ctx, value) -> Optional[float]:
    """The mean over the untraced proves of `value(root, requests)`, which
    may give None for a prove it finds nothing in."""
    req = requests(ctx, f"hyperplonk_prove-{ctx.config['k']}")
    if req is None:
        return None
    values = [v for v in (value(root, req) for root in req.roots) if v is not None]
    return sum(values) / len(values) if values else None
