# Copied from plonkish_tpu/utils/timer.py; spans synchronise the device and print nothing.
"""Hierarchical timing spans (reference util/timer.rs + ark_std print-trace).

Enabled via PLONKISH_TPU_TIMER=1 or `set_enabled(True)`.  Span names follow
the reference's `name-k` convention so cost-breakdown tooling can group them
(plotter.rs:16-57 parses the same shape).  Spans nest; every span records
(name, depth, seconds) into a global trace retrievable by the benchmark
harness.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Tuple

_enabled = os.environ.get("PLONKISH_TPU_TIMER", "0") == "1"
_depth = 0
_trace: List[Tuple[str, int, float]] = []
# Called at both ends of a span when set (torch.cuda.synchronize on the card),
# so that a span's time covers the device work enqueued inside it.
_sync = None


def set_sync(fn) -> None:
    global _sync
    _sync = fn


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset_trace() -> None:
    _trace.clear()


def trace() -> List[Tuple[str, int, float]]:
    return list(_trace)


@contextlib.contextmanager
def span(name: str):
    global _depth
    if not _enabled:
        yield
        return
    depth = _depth
    _depth += 1
    if _sync is not None:
        _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if _sync is not None:
            _sync()
        dt = time.perf_counter() - t0
        _depth -= 1
        _trace.append((name, depth, dt))


def cost_breakdown(categories=None):
    """Aggregate the trace into category -> seconds, mirroring the
    reference plotter's grouping of timer logs."""
    categories = categories or {
        "sum_check": ("zero_check", "sum_check"),
        "pcs": ("pcs_batch_open", "witness_commit"),
        "witness": ("witness_collector",),
        "lookup_m": ("lookup_m_polys",),  # must precede the "lookup" prefix
        "lookup": ("lookup",),
        "permutation": ("permutation",),
    }
    out = {k: 0.0 for k in categories}
    out["other"] = 0.0
    for name, depth, dt in _trace:
        if depth != 0:
            continue  # top-level prover phases only
        for cat, prefixes in categories.items():
            if any(name.startswith(p) for p in prefixes):
                out[cat] += dt
                break
        else:
            out["other"] += dt
    return out
