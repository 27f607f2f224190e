"""One run of one cell: set up, warm up, measure a window, check, report.

Everything that belongs to one configuration, traffic mix or metric is found
by its name in BENCHMARK.json: ``configs/<config>.json`` (its ``system`` key
names ``systems/<system>.py``), ``traffic/<traffic>.json`` (read by
generator.py) and ``metrics/<metric>.py`` (a ``read(ctx)`` that returns the
value or None).  Adding a cell, a mix or a metric adds files; it edits none.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback
from typing import List, Optional, Tuple

from . import generator
from . import trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "plonkish_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the port's runs must not load,
    compared whole: ``plonkish_tpu_torch`` is not ``plonkish_tpu``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_spec(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, workload: str) -> Tuple[dict, dict]:
    for w in spec["workloads"]:
        if w["name"] == workload:
            for c in spec["configs"]:
                if c["name"] == w["config"]:
                    return w, c
            raise KeyError(f"workload {workload} names no configuration of BENCHMARK.json")
    raise KeyError(f"no workload {workload} in BENCHMARK.json")


def metrics_of(spec: dict, workload: str, kind: str) -> List[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that `workload` reports."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def reader(name: str, root: str = HERE):
    path = os.path.join(root, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"proofbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def system_class(system: str):
    return importlib.import_module(f".systems.{system}", __package__).System


@dataclasses.dataclass
class Context:
    """What the metric readers see of one run."""
    config: dict
    traffic: generator.Traffic
    setup_s: float
    window_s: float
    requests: List[generator.Request]
    windows: List[Tuple[float, float]]  # each request's start and end, host clock
    latencies: List[float]  # each request's time from its input's being ready
    answered: List[Tuple[float, float]]  # each request from its input's being ready to its end
    failed: int
    peak_bytes: Optional[int]  # device memory peak over the window
    spans: List[tracing.Span]  # traced runs: the program's and the harness's
    traced: int  # the requests the profiler recorded, from the first
    device: Optional[tracing.DeviceTrace]
    profiled: Optional[Tuple[float, float]]

    @property
    def count(self) -> int:
        return len(self.requests)

    def untraced_windows(self) -> List[Tuple[float, float]]:
        """The requests the profiler did not slow, or all where none is left."""
        return self.windows[self.traced:] or self.windows

    def span_seconds_per_request(self, match) -> Optional[float]:
        """Seconds a request of the program's spans whose name `match`es,
        over the requests the profiler did not record."""
        wins = self.untraced_windows()
        total, seen = 0.0, False
        for name, depth, s, e in self.spans:
            if depth >= 0 and match(name) and any(a <= s < b for a, b in wins):
                total += e - s
                seen = True
        return total / len(wins) if seen else None


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        spec_path: Optional[str] = None, config_overrides: Optional[dict] = None,
        fault: Optional[str] = None, cache_dir: str = CACHE,
        t_start: Optional[float] = None, start_phases: Optional[dict] = None,
        log=sys.stderr) -> dict:
    """One run; returns the result line's object.  `device` None means the
    card, which the caller has checked is there.  `start_phases` are parts of
    the time from `t_start` to the system's making, reported beside it."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from plonkish_tpu_torch.utils import timer

    spec = load_spec(spec_path)
    w, c = cell(spec, workload)
    with open(os.path.join(REPO, c["file"])) as f:
        cfg = dict(json.load(f), **(config_overrides or {}))
    traffic = generator.load(w["traffic"])
    device = torch.device("cuda" if device is None else device)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    timer.set_enabled(bool(trace))
    timer.set_sync(sync if trace and on_card else None)
    spans = tracing.attach(timer) if trace else None

    t_system = time.perf_counter()
    system = system_class(cfg["system"])(cfg, traffic, seed, device, cache_dir, fault)
    if system.span != traffic.op:
        raise ValueError(f"traffic {traffic.name} asks for {traffic.op}, {cfg['system']} serves {system.span}")
    system.warm_up()
    sync()
    setup_s = time.perf_counter() - t_start
    phases = {"start": t_system - t_start, **(start_phases or {}), **system.phases}
    if spans is not None:
        spans.timed.clear()

    requests, windows, latencies, answered, answers, failed = [], [], [], [], {}, 0
    prof, profiled, mark = None, None, None
    stream = generator.stream(traffic)
    collections = _GcClock()
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    end = t0
    while not requests or end - t0 < seconds:
        req = next(stream)
        if trace and on_card and not requests:
            from torch.profiler import ProfilerActivity, profile

            # The device's activity alone: a prove's host operations are too
            # many to record and read back inside a run's time.
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
            mark = tracing.DeviceTrace.clock_mark(device)
        start = time.perf_counter()
        try:
            prepared = system.prepare(req)
            ready = time.perf_counter()
            answers[req.index] = system.run(prepared)
        except Exception:
            ready = start
            failed += 1
            traceback.print_exc(file=log)
        end = time.perf_counter()
        requests.append(req)
        windows.append((start, end))
        latencies.append(end - ready)
        answered.append((ready, end))
        if prof is not None and len(requests) == traffic.traced_requests:
            sync()
            profiled = (windows[0][0], time.perf_counter())
            prof.__exit__(None, None, None)
            end = time.perf_counter()
    if prof is not None and profiled is None:
        sync()
        profiled = (windows[0][0], time.perf_counter())
        prof.__exit__(None, None, None)
    window_s = windows[-1][1] - t0
    collections.stop()
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    process_peak = max(peak, setup_peak) if on_card else 0
    if spans is not None:
        spans.timed.extend((system.span, -1, a, b) for a, b in windows)

    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    device_trace = tracing.DeviceTrace(prof, mark) if prof is not None else None
    ctx = Context(cfg, traffic, setup_s, window_s, requests, windows, latencies, answered, failed,
                  peak,
                  list(spans.timed) if spans is not None else [],
                  min(traffic.traced_requests, len(requests)) if trace else 0,
                  device_trace, profiled)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, workload, kind):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"attempted": len(requests), "failed": failed, "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": 1, "memory_peak_bytes": process_peak}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": process_peak}
    if trace and device_trace is not None:
        lo, hi = profiled
        result["device"]["busy_s"] = device_trace.busy_seconds(lo, hi)
        result["device"]["window_s"] = hi - lo
        result["breakdown"] = {
            "device_ops": tracing.top(device_trace.op_seconds(lo, hi)),
            "idle_gaps": tracing.top(tracing.idle_by_span(
                device_trace.intervals(), ctx.spans, lo, hi)),
        }

    # The reference runs once the window is closed, its peak read, and the
    # program's state freed.
    picked = generator.sample(traffic, seed, len(requests))
    system.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = [("requests_failed", failed, 0)] + system.check(
        {i: answers[i] for i in picked if i in answers}, requests)
    check_s = time.perf_counter() - t_check
    result["correct"] = bool(requests) and all(v <= limit for _, v, limit in checks)
    # Beside the contract's keys, for the reader of a run: the set-up's
    # phases, the spread of the requests' own times, the reference's time.
    result["setup_phases"] = phases
    lat = sorted(latencies)
    result["request_s"] = {"min": lat[0], "median": lat[len(lat) // 2], "max": lat[-1]}
    result["gc_window"] = collections.summary()
    result["check_s"] = check_s
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    order = ["correct", "attempted", "failed", "metrics", "device", "breakdown", "setup_phases",
             "request_s", "gc_window", "check_s", "checks"]
    return {k: result[k] for k in order if k in result}


class _GcClock:
    """Counts the interpreter's garbage collections, and their seconds, by
    generation, from its making to ``stop``."""

    def __init__(self):
        self.count, self.seconds, self._t = [0, 0, 0], [0.0, 0.0, 0.0], None
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.count[info["generation"]] += 1
            self.seconds[info["generation"]] += time.perf_counter() - self._t

    def stop(self) -> None:
        if self._callback in gc.callbacks:
            gc.callbacks.remove(self._callback)

    def summary(self) -> dict:
        return {"collections": self.count, "seconds": self.seconds}


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules the port's runs must not load: " + ", ".join(names))
        self.names = names


def checks_text(result: dict) -> str:
    return "\n".join(f"check {name}: {c['value']} (limit {c['limit']})"
                     for name, c in result["checks"].items())
