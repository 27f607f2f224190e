# Copied from plonkish_tpu/utils/timer.py; spans synchronise the device and print nothing.
"""Hierarchical timing spans (reference util/timer.rs + ark_std print-trace).

Enabled via PLONKISH_TPU_TIMER=1 or `set_enabled(True)`.  Span names follow
the reference's `name-k` convention so cost-breakdown tooling can group them
(plotter.rs:16-57 parses the same shape).  Spans nest; every span records
(name, depth, seconds) into a global trace retrievable by the benchmark
harness.

While tracing is on, every span also leaves a ``Record`` (``records()``): its
id, its parent's and its root's (the spans of one request share the root's),
its start and end on ``time.perf_counter()``, and the counters accrued while
it was the innermost open span: ``launches`` (increments of
``kernels.LAUNCHES``), ``ints_in`` / ``ints_out`` (elements converted between
Python ints and limb tensors, ``fields/limb.py``) and ``device_reads`` (host
reads that waited on the card, ``device_read``).  A span that synchronises
also takes the thread's CPU time, page faults and context switches over it
(two system calls at each end).

A span opened with ``sync=False`` (a stage) never synchronises and takes no
system call.  On a CUDA device it records a CUDA event pair on the card's
stream (the current stream at the card's first stage; events come from a
pool).  Once its request's root has closed and the request's last event has
completed, the pair resolves into ``Record.device``: the stage's stretch on
the card, idle time included, in seconds from the request's first event
there.  Events are resolved when records are read, or where a stage inside
a request closes before the card has begun it (the card then has at least
the stage's work queued, and runs it while the host resolves), never by a
sync of their own.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import resource
import time
from typing import Dict, List, Optional, Tuple

from .. import config

_enabled = config.timer_enabled()
_trace: List[Tuple[str, int, float]] = []
# Called at both ends of a span when set (torch.cuda.synchronize on the card),
# so that a span's time covers the device work enqueued inside it.
_sync = None
# Records kept while tracing is on: beyond this many, the oldest go.
MAX_RECORDS = 1 << 16
# Closed requests whose events wait: beyond this many, a root's close
# resolves them (a card that never falls behind the host).
PENDING_MAX = 1 << 10


@dataclasses.dataclass(eq=False, slots=True)
class Record:
    """One closed span.  ``start``/``end`` are host seconds on
    ``time.perf_counter()``.  ``sync`` is False for a stage; ``request``
    marks a span where a request enters the program.  ``cpu_s`` and the
    fault and switch counts cover the whole span, its children included (None
    on a stage); ``counters`` only what accrued while it was the
    innermost open span.  ``device`` is a stage's stretch on the card, in
    seconds from its request's first event there."""
    id: int
    parent: Optional[int]
    root: int
    name: str
    depth: int
    start: float = 0.0
    end: float = 0.0
    sync: bool = True
    request: bool = False
    cpu_s: Optional[float] = None
    minor_faults: Optional[int] = None
    major_faults: Optional[int] = None
    voluntary_switches: Optional[int] = None
    involuntary_switches: Optional[int] = None
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    device: Optional[Tuple[float, float]] = None
    _at_open: tuple = dataclasses.field(default=(), repr=False)
    _events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def seconds(self) -> float:
        return self.end - self.start


_records = collections.deque(maxlen=MAX_RECORDS)  # closed spans, in closing order
_stack: List[Record] = []  # open spans, innermost last
# The open request's first event on the card, (card index, event), and its
# stages that closed with an event pair, in closing order.
_origin: Optional[Tuple[int, object]] = None
_staged: List[Record] = []
_pending = collections.deque()  # closed requests' (origin, stages), unresolved
_pool: Dict[int, list] = {}  # card index -> events free for a stage
_cards: Dict[object, Optional[Tuple[int, object]]] = {}  # device -> (index, stream)
_ids = 0
_launches_seen = 0
_launches = None  # kernels.LAUNCHES, imported at first use


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
    _records.clear()
    _pending.clear()


def trace() -> List[Tuple[str, int, float]]:
    return list(_trace)


def records() -> List[Record]:
    """The records of the spans closed since the last reset, in the order
    they closed, with every stretch on the card whose events have completed."""
    _resolve()
    return list(_records)


def self_seconds(recs: List[Record]) -> Dict[int, float]:
    """Each record's duration less the durations of its direct children
    (children do not overlap: spans nest as calls do): id -> seconds."""
    out = {r.id: r.seconds for r in recs}
    for r in recs:
        if r.parent in out:
            out[r.parent] -= r.seconds
    return out


def count(name: str, n: int = 1) -> None:
    """Adds n to counter `name` of the innermost open span (tracing on)."""
    if _enabled and _stack:
        counters = _stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def device_read(t) -> None:
    """Called after a host read of tensor `t` (``.cpu()``, ``.item()``,
    ``.tolist()``, ``bool()``): counts it where it waited on the card."""
    if _enabled and t.is_cuda:
        count("device_reads")


@contextlib.contextmanager
def span(name: str, sync: bool = True, device=None, request: bool = False):
    """A span.  With ``sync=False`` (a stage) it never calls the sync that
    is set; on a CUDA `device` it then records an event pair.  ``request``
    marks where a request enters the program: ``phase_trace`` counts depth
    from its children."""
    if not _enabled:
        yield
        return
    if sync and _sync is not None:
        _sync()
    rec = _open(name, sync, device, request)
    try:
        yield
    finally:
        if sync and _sync is not None:
            _sync()
        _close(rec)


def _open(name: str, sync: bool, device, request: bool) -> Record:
    global _ids, _origin
    parent = _stack[-1] if _stack else None
    _take_launches(parent)
    _ids += 1
    rec = Record(_ids, parent.id if parent else None, parent.root if parent else _ids, name,
                 len(_stack), sync=sync, request=request)
    if sync:
        rec._at_open = (time.thread_time(), resource.getrusage(resource.RUSAGE_THREAD))
    if not sync and device is not None:
        card = _card(device)
        if card is not None and (_origin is None or _origin[0] == card[0]):
            ev = _record(card)
            rec._events = (card, ev)
            if _origin is None:
                _origin = (card[0], ev)
    _stack.append(rec)
    rec.start = time.perf_counter()
    return rec


def _close(rec: Record) -> None:
    global _origin, _staged
    if rec._events is not None:
        card, ev = rec._events
        rec._events = (ev, _record(card))
        _staged.append(rec)
    rec.end = time.perf_counter()
    _trace.append((rec.name, rec.depth, rec.end - rec.start))
    if rec._at_open:
        cpu0, ru0 = rec._at_open
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        rec.cpu_s = time.thread_time() - cpu0
        rec.minor_faults = ru.ru_minflt - ru0.ru_minflt
        rec.major_faults = ru.ru_majflt - ru0.ru_majflt
        rec.voluntary_switches = ru.ru_nvcsw - ru0.ru_nvcsw
        rec.involuntary_switches = ru.ru_nivcsw - ru0.ru_nivcsw
        rec._at_open = ()
    _take_launches(rec)
    _stack.pop()
    _records.append(rec)
    if _stack:
        if _pending and rec._events is not None and not rec._events[0].query():
            _resolve()
    elif _staged:
        _pending.append((_origin, _staged))
        _origin, _staged = None, []
        if len(_pending) > PENDING_MAX:
            _resolve()


def _take_launches(rec: Optional[Record]) -> None:
    """Credits the launches since the last boundary to `rec` (dropped where
    no span is open; a reset of LAUNCHES in between counts from zero)."""
    global _launches, _launches_seen
    if _launches is None:
        from ..kernels import LAUNCHES

        _launches = LAUNCHES
    total = sum(_launches.values())
    new = total - _launches_seen if total >= _launches_seen else total
    _launches_seen = total
    if new and rec is not None:
        rec.counters["launches"] = rec.counters.get("launches", 0) + new


# ---------------------------------------------------------------- the card
def _card(device) -> Optional[Tuple[int, object]]:
    """(index, stream) of a CUDA `device`, None for another device."""
    try:
        return _cards[device]
    except KeyError:
        pass
    import torch

    d = torch.device(device)
    card = None
    if d.type == "cuda":
        index = torch.cuda.current_device() if d.index is None else d.index
        card = (index, torch.cuda.current_stream(index))
    _cards[device] = card
    return card


def _new_event():
    import torch

    return torch.cuda.Event(enable_timing=True)


def _record(card):
    """An event from the card's pool, or a new one, recorded on its stream."""
    index, stream = card
    pool = _pool.get(index)
    ev = pool.pop() if pool else _new_event()
    ev.record(stream)
    return ev


def _resolve() -> None:
    """Turns the closed requests whose last event has completed (the
    stream runs them in order) into stretches, and frees their events."""
    while _pending:
        (index, origin), stages = _pending[0]
        if not stages[-1]._events[1].query():
            return
        _pending.popleft()
        pool = _pool.setdefault(index, [])
        for rec in stages:
            ev0, ev1 = rec._events
            rec.device = (1e-3 * origin.elapsed_time(ev0), 1e-3 * origin.elapsed_time(ev1))
            rec._events = None
            pool += (ev0, ev1)


# ------------------------------------------------------------- readers
def phase_trace() -> List[Tuple[str, int, float]]:
    """(name, depth, seconds) of the recorded spans that synchronise, as
    ``trace()`` gives them but without the stages, and with depth counted
    from a request's phases: under a root opened with ``request=True`` (at
    -1 here) its children are at 0."""
    requests = {r.id for r in _records if r.request and r.parent is None}
    return [(r.name, r.depth - (r.root in requests), r.seconds) for r in _records if r.sync]


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
    for name, depth, dt in phase_trace():
        if depth != 0:
            continue  # top-level prover phases only
        for cat, prefixes in categories.items():
            if any(name.startswith(p) for p in prefixes):
                out[cat] += dt
                break
        else:
            out["other"] += dt
    return out
