"""The readers of the program's span records (``proofbench/spans.py``): the
commit's stages on the card, and the prove cell's zero-check set-up, batch
open sum-check, off-CPU time and page faults.

    python -m pytest -p no:cacheprovider proofbench/tests/test_proofbench_spans.py

On the CPU no span has a stretch on the card, so the commit's readers are
checked on records made by hand; the test marked ``gpu`` runs a traced
commit window on the card and holds the stages against the profiler's
trace."""

import json
import statistics

import pytest
import torch

from proofbench import harness
from plonkish_tpu_torch.utils import timer

PROVE, COMMIT = "hyperplonk_kzg_vanilla_k20.prove", "mlkzg_bn254_k20.commit"
SEED = 2**31 + 7654321
COMMIT_READERS = ("from_mont_ms", "msm_recode_ms", "msm_bucket_ms", "msm_window_ms",
                  "commit_gap_ms")
PROVE_READERS = ("zero_check_setup_ms", "batch_open_sum_check_ms", "prove_offcpu_ms",
                 "prove_minor_faults")
STAGES = ("kzg_from_mont", "msm_recode", "msm_bucket_sums", "msm_window_sums", "msm_readback")

# The prove cell is not in BENCHMARK.json (PERF.md, Open questions): its
# entries and the readers of its spans, as a later change would add them.
PROVE_ENTRIES = {
    "configs": [{"name": "hyperplonk_kzg_vanilla_k20", "source": "proof_system.rs",
                 "file": "proofbench/configs/hyperplonk_kzg_vanilla_k20.json", "reduced": [],
                 "why": "HyperPlonk over multilinear KZG"}],
    "workloads": [{"name": PROVE, "config": "hyperplonk_kzg_vanilla_k20", "traffic": "prove",
                   "chips": 1, "why": "one prover, closed loop"}],
    "end_to_end": [{"name": "prove_s", "unit": "s", "better": "lower", "bound": 0.25,
                    "source": "host_clock", "workloads": [PROVE]}],
    "per_layer": [{"name": name, "unit": unit, "better": "lower", "source": "program_span",
                   "layer": "layer", "moves": "prove_s", "workloads": [PROVE]}
                  for name, unit in [("zero_check_ms", "ms"), ("batch_open_ms", "ms"),
                                     ("zero_check_setup_ms", "ms"),
                                     ("batch_open_sum_check_ms", "ms"),
                                     ("prove_offcpu_ms", "ms"), ("prove_minor_faults", "faults")]],
}


@pytest.fixture(scope="module")
def spec_path(tmp_path_factory):
    spec = harness.load_spec()
    for key, entries in PROVE_ENTRIES.items():
        spec[key] += entries
    path = tmp_path_factory.mktemp("spec") / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return str(path)


def test_prove_traced_reads_the_record_metrics(tmp_path, spec_path):
    result = harness.run(PROVE, SEED, 0.2, True, device="cpu", config_overrides={"k": 4},
                         cache_dir=str(tmp_path / "cache"), spec_path=spec_path)
    assert result["correct"] and result["failed"] == 0
    m = {name: v["value"] for name, v in result["metrics"].items()}
    assert set(m) == {"zero_check_ms", "batch_open_ms", *PROVE_READERS}
    assert all(isinstance(v, float) for v in m.values())
    assert 0 < m["zero_check_setup_ms"] < m["zero_check_ms"]
    assert 0 < m["batch_open_sum_check_ms"] < m["batch_open_ms"]
    assert m["prove_minor_faults"] >= 0


def test_commit_traced_on_the_cpu_leaves_the_stage_metrics_out(tmp_path):
    result = harness.run(COMMIT, SEED, 0.2, True, device="cpu", config_overrides={"k": 3},
                         cache_dir=str(tmp_path / "cache"))
    assert result["correct"]
    # no stretch on the card, too few commits for a tail, no profiler
    assert result["metrics"] == {}
    recs = timer.records()
    roots = [r for r in recs if r.parent is None and r.name == "kzg_commit-3"]
    assert roots and all(r.device is None for r in recs)
    kids = [r.name for r in recs if r.parent == roots[-1].id]
    assert kids == [f"{s}-3" for s in STAGES]


def _rec(id_, name, device, parent=None, root=1, start=0.0):
    return timer.Record(id=id_, parent=parent, root=root, name=name, depth=int(parent is not None),
                        start=start, end=start + 0.03, device=device)


class _Ctx:
    config = {"k": 20}

    def __init__(self, windows):
        self.windows = windows

    def untraced_windows(self):
        return self.windows


def _commit(first_id, t):
    """A commit's records at host time t: stages on the card at ms 0.2-3.2,
    3.2-10, 10-21, 21-24 and 24.3-24.4 of a root stretch 0-24.5."""
    ms = 1e-3
    root = _rec(first_id, "kzg_commit-20", (t, t + 24.5 * ms), start=t)
    bounds = [(0.2, 3.2), (3.2, 10.0), (10.0, 21.0), (21.0, 24.0), (24.3, 24.4)]
    return [root] + [_rec(first_id + 1 + i, f"{s}-20", (t + a * ms, t + b * ms), first_id,
                          first_id, t) for i, (s, (a, b)) in enumerate(zip(STAGES, bounds))]


def test_commit_stage_readers_on_records_with_device_stretches(monkeypatch):
    recs = _commit(1, 10.0) + _commit(10, 20.0) + _commit(20, 30.0)
    monkeypatch.setattr(timer, "records", lambda: recs)
    ctx = _Ctx([(19.9, 20.1), (29.9, 30.1)])  # the commit at 10 s was profiled
    got = {name: harness.reader(name).read(ctx) for name in COMMIT_READERS}
    want = {"from_mont_ms": 3.0, "msm_recode_ms": 6.8, "msm_bucket_ms": 11.0,
            "msm_window_ms": 3.0, "commit_gap_ms": 0.2 + 0.3 + 0.1}
    assert got == pytest.approx(want, abs=1e-9)
    # the five and the read-back's 0.1 ms make the root's whole stretch
    assert sum(got.values()) + 0.1 == pytest.approx(24.5)


def test_a_commit_with_an_unresolved_stage_is_not_read(monkeypatch):
    recs = _commit(1, 10.0)
    recs[2].device = None  # the recode's events had not completed
    monkeypatch.setattr(timer, "records", lambda: recs)
    ctx = _Ctx([(9.9, 10.1)])
    assert harness.reader("msm_recode_ms").read(ctx) is None
    assert harness.reader("commit_gap_ms").read(ctx) is None
    assert harness.reader("msm_bucket_ms").read(ctx) == pytest.approx(11.0)


@pytest.mark.parametrize("name", COMMIT_READERS + PROVE_READERS)
def test_readers_are_silent_where_the_program_keeps_no_records(monkeypatch, name):
    """As on a program older than the records: no value, no error."""
    monkeypatch.delattr(timer, "records")
    assert harness.reader(name).read(_Ctx([(0.0, 1.0)])) is None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# A spin of about 2 ms on the card before each profiled commit: the host
# enqueues the commit's first event and kernels while it runs, so that event
# completes as the spin ends, which ties the records to the profiler's clock.
SPIN_CYCLES = 4_000_000
TIE_US = 20.0  # the commit's first kernel starts this close to the spin's end
HOLD_US = 20.0  # K1's operations lie inside msm_bucket_sums-20 to this


def _union_us(intervals):
    out, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        a = max(a, end)
        if b > a:
            out, end = out + b - a, b
    return out


def placed_commits(recs, ops, k):
    """Per commit behind a spin: {stage: (start, end) in µs on the
    profiler's clock}, its operations (name, start, end), and how far after
    the spin's end its first operation starts.  `ops` are the profiler's
    device operations in µs, sorted by start."""
    roots = [r for r in recs if r.parent is None and r.name == f"kzg_commit-{k}"]
    spins = [i for i, (name, _, _) in enumerate(ops) if "spin" in name.lower()]
    assert len(spins) == len(roots), ([n for n, _, _ in ops[:40]], len(roots))
    out = []
    for n, (root, i) in enumerate(zip(roots, spins)):
        tie = ops[i][2]
        mine = ops[i + 1:spins[n + 1] if n + 1 < len(spins) else len(ops)]
        placed = {r.name.rsplit("-", 1)[0]: (tie + 1e6 * r.device[0], tie + 1e6 * r.device[1])
                  for r in [root] + [c for c in recs if c.parent == root.id]}
        out.append((placed, mine, mine[0][1] - tie))
    return out


@pytest.mark.gpu
def test_commit_stages_on_the_card_hold_their_kernels(cuda, tmp_path, monkeypatch):
    """A traced window reads the five stage metrics, which add up to the
    root's stretch, and its idle gaps are named by the stages.  Then, under
    the profiler, each of 20 commits behind a spin: msm_bucket_sums-20 holds
    every K1 operation of its commit, to 20 µs at either end.  Printed: the
    largest offsets, and each stage's busy and idle time on the card."""
    from torch.profiler import ProfilerActivity, profile

    from proofbench import generator
    from proofbench.systems.mlkzg_commit import System

    seen = []

    class Kept(harness.Context):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)

    monkeypatch.setattr(harness, "Context", Kept)
    result = harness.run(COMMIT, SEED, 10.0, True, cache_dir=str(tmp_path))
    assert result["correct"]
    got = {name: result["metrics"][name]["value"] for name in COMMIT_READERS}
    roots = [r for r in timer.records() if r.parent is None and r.name == "kzg_commit-20"
             and any(a <= r.start < b for a, b in seen[-1].untraced_windows())]
    stretch = 1e3 * sum(r.device[1] - r.device[0] for r in roots) / len(roots)
    assert abs(sum(got.values()) - stretch) <= 0.03 * stretch
    gaps = [name for name, _ in result["breakdown"]["idle_gaps"]]
    assert any(name.startswith(STAGES) for name in gaps), gaps

    system = System(json.load(open(f"{harness.REPO}/proofbench/configs/mlkzg_bn254_k20.json")),
                    generator.load("commit"), SEED, cuda, str(tmp_path))
    timer.reset_trace()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            poly = system.prepare_draw(i)
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            system.run(poly)
    ops = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda op: op[1])
    commits = placed_commits(timer.records(), ops, 20)
    leads = [lead for _, _, lead in commits]
    assert max(leads) <= TIE_US, leads  # the host enqueued the commit during the spin
    held, busy = [], {}
    for placed, mine, _ in commits:
        lo, hi = placed["msm_bucket_sums"]
        k1 = [(s, e) for name, s, e in mine if "bucket_level_kernel" in name]
        held.append((min(s for s, _ in k1) - lo, hi - max(e for _, e in k1)))
        for stage, (a, b) in placed.items():
            on = _union_us([(max(s, a), min(e, b)) for _, s, e in mine if min(e, b) > max(s, a)])
            busy.setdefault(stage, []).append((on, b - a - on))
    table = {stage: [round(statistics.fmean(v[0] for v in vs) / 1e3, 4),
                     round(statistics.fmean(v[1] for v in vs) / 1e3, 4)]
             for stage, vs in busy.items()}
    print(f"stages {got}, root stretch {stretch:.4f} ms; behind a spin, the first kernel "
          f"{min(leads):.2f}-{max(leads):.2f} us after it; K1 inside msm_bucket_sums-20 by "
          f"(start, end) us {[(round(a, 2), round(b, 2)) for a, b in held]}; "
          f"busy and idle ms a commit by stage {table}")
    assert all(a >= -HOLD_US and b >= -HOLD_US for a, b in held), held
