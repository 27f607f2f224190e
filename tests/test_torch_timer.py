"""The port's tracer (plonkish_tpu_torch/utils/timer.py): span records with
ids, parents and roots, self time, the counters, stages' stretches on a
made-up card, resolved from the request's first event, and the (name, depth,
seconds) trace that readers swap in, on the CPU.  A k = 5 HyperPlonk prove
is traced once for the module."""

import random
import time
import types

import pytest

from plonkish_tpu_torch import kernels
from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
from plonkish_tpu_torch.poly.multilinear import MLPoly
from plonkish_tpu_torch.utils import timer
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

STAGES = ("kzg_from_mont", "msm_recode", "msm_bucket_sums", "msm_window_sums", "msm_readback")


@pytest.fixture
def tracing(monkeypatch):
    """Tracing on, no sync, an empty trace; all put back afterwards."""
    monkeypatch.setattr(timer, "_enabled", True)
    monkeypatch.setattr(timer, "_sync", None)
    monkeypatch.setattr(timer, "_trace", [])
    timer.reset_trace()
    yield
    timer.reset_trace()


class Syncs:
    def __init__(self):
        self.calls = 0

    def __call__(self):
        self.calls += 1


@pytest.fixture(scope="module")
def prove5():
    """One k = 5 vanilla HyperPlonk prove over KZG, traced with a counting
    sync; what the tracer kept of it."""
    ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, 5, random.Random(1), random.Random(2))
    backend = HyperPlonk(MultilinearKzg(device="cpu"))
    pp, _ = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    saved = timer._enabled, timer._sync, timer._trace
    syncs = Syncs()
    timer._trace = []
    timer.reset_trace()
    timer.set_enabled(True)
    timer.set_sync(syncs)
    try:
        tr = Keccak256Transcript(BN254_FR)
        backend.prove(pp, circuit, tr)
        recs, triples = timer.records(), timer.trace()
        out = types.SimpleNamespace(records=recs, trace=triples, syncs=syncs.calls,
                                    breakdown=timer.cost_breakdown(),
                                    phases=timer.phase_trace(), proof=tr.into_proof())
    finally:
        timer._enabled, timer._sync, timer._trace = saved
        timer.reset_trace()
    return out


SHAPES = {  # (name, children) in call order
    "flat": [("a", []), ("b", []), ("c", [])],
    "chain": [("a", [("b", [("c", [])])])],
    "tree": [("a", [("b", []), ("c", [("d", [])])]), ("e", [])],
}


def _run(shape):
    for name, kids in shape:
        with timer.span(name):
            time.sleep(0.002)
            _run(kids)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_records_nest_as_the_calls_do(tracing, shape):
    with timer.span("root"):
        _run(SHAPES[shape])
    recs = timer.records()
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs) == len(timer.trace())
    root = next(r for r in recs if r.name == "root")
    assert root.parent is None and root.depth == 0 and recs[-1] is root
    for r in recs:
        assert r.root == root.id
        if r is not root:
            parent = by_id[r.parent]
            assert r.depth == parent.depth + 1
            assert parent.start <= r.start <= r.end <= parent.end
    own = timer.self_seconds(recs)
    for r in recs:
        kids = [c for c in recs if c.parent == r.id]
        assert own[r.id] == pytest.approx(r.seconds - sum(c.seconds for c in kids), abs=1e-12)
        assert own[r.id] >= 0.002 * (r is not root) - 1e-4


def test_each_request_has_its_own_root(tracing):
    for _ in range(2):
        with timer.span("request"):
            with timer.span("phase"):
                pass
    recs = timer.records()
    roots = [r for r in recs if r.parent is None]
    assert len(roots) == 2 and roots[0].id != roots[1].id
    for phase in (r for r in recs if r.name == "phase"):
        assert phase.parent == phase.root and phase.root in {r.id for r in roots}


def test_a_span_records_cpu_time_faults_and_switches(tracing):
    with timer.span("sleep"):
        time.sleep(0.05)
    with timer.span("work"):
        sum(i * i for i in range(300000))
        bytearray(64 << 20)  # fresh pages: minor faults
    sleep, work = timer.records()
    assert sleep.seconds - sleep.cpu_s >= 0.04
    assert work.cpu_s > 0.5 * work.seconds > 0
    assert work.minor_faults > 0 and sleep.voluntary_switches >= 1
    for r in (sleep, work):
        assert r.major_faults >= 0 and r.involuntary_switches >= 0


ROOT5 = "hyperplonk_prove-5"


@pytest.mark.parametrize("child,parents", [
    ("witness_collector-0", {ROOT5}),
    ("witness_commit-0", {ROOT5}),
    # the witness commitments, and the permutation z polys' between phases
    ("kzg_commit-5", {"witness_commit-0", ROOT5}),
    ("zero_check", {ROOT5}),
    ("sum_check_prove-5-5", {"zero_check"}),
    ("pcs_batch_open-14", {ROOT5}),
    ("sum_check_prove-5-2", {"pcs_batch_open-14"}),
])
def test_a_prove_has_one_root_and_its_phases_under_it(prove5, child, parents):
    recs = prove5.records
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [ROOT5]
    found = [r for r in recs if r.name == child]
    assert found and {by_id[r.parent].name for r in found} == parents
    assert all(r.root == roots[0].id for r in found)


def test_a_traced_prove_gives_the_golden_proof(prove5):
    assert prove5.proof == open("tests/golden/hyperplonk_kzg_k5.bin", "rb").read()


def test_a_commit_is_its_stages_in_order(prove5):
    recs = prove5.records
    for root in (r for r in recs if r.name == "kzg_commit-5"):
        assert [r.name for r in recs if r.parent == root.id] == [f"{s}-5" for s in STAGES]


def test_spans_that_synchronised_still_do_and_stages_never(prove5):
    stages = [r for r in prove5.records if not r.sync]
    assert stages and all(r.name.startswith(("kzg_commit",) + STAGES) for r in stages)
    assert prove5.syncs == 2 * (len(prove5.records) - len(stages))


@pytest.mark.parametrize("sync", [True, False])
def test_trace_gets_triples_and_a_stage_never_syncs(tracing, sync):
    syncs = Syncs()
    timer.set_sync(syncs)
    with timer.span("outer", sync=sync):
        with timer.span("inner", sync=sync, device="cpu"):
            time.sleep(0.001)
    assert syncs.calls == (4 if sync else 0)
    trace = timer.trace()
    assert [(n, d) for n, d, _ in trace] == [("inner", 1), ("outer", 0)]
    recs = timer.records()
    for (_, _, seconds), r in zip(trace, recs):
        assert isinstance(seconds, float) and seconds == r.seconds
        assert r.device is None  # no card


def test_a_swapped_trace_list_receives_each_span_as_it_closes(tracing, monkeypatch):
    class Stamping(list):
        def append(self, item):
            super().append((item, time.perf_counter()))

    log = Stamping()
    monkeypatch.setattr(timer, "_trace", log)
    with timer.span("a", sync=False):
        pass
    (name, depth, seconds), stamped = log[0]
    rec = timer.records()[0]
    assert (name, depth, seconds) == ("a", 0, rec.seconds) and rec.end <= stamped


def test_cost_breakdown_of_a_prove_counts_its_phases(prove5):
    got = prove5.breakdown
    assert list(got) == ["sum_check", "pcs", "witness", "lookup_m", "lookup", "permutation",
                         "other"]
    phases = [(n, s) for n, d, s in prove5.phases if d == 0]

    def total(*prefixes):
        return sum(s for n, s in phases if n.startswith(prefixes))

    assert got["sum_check"] == pytest.approx(total("zero_check"))
    assert got["pcs"] == pytest.approx(total("pcs_batch_open", "witness_commit"))
    assert got["witness"] == pytest.approx(total("witness_collector"))
    assert got["lookup_m"] == pytest.approx(total("lookup_m_polys"))
    assert got["lookup"] == pytest.approx(total("lookup_compressed", "lookup_h"))
    assert got["permutation"] == pytest.approx(total("permutation"))
    assert got["other"] == 0.0


def test_phase_depth_counts_from_the_prove_phases(prove5):
    depth = {n: d for n, d, _ in prove5.phases}
    assert depth["hyperplonk_prove-5"] == -1
    assert depth["zero_check"] == depth["witness_commit-0"] == 0
    assert depth["sum_check_prove-5-5"] == 1
    raw = {n: d for n, d, _ in prove5.trace}
    assert raw["zero_check"] == 1 and raw["hyperplonk_prove-5"] == 0
    # the stages are no phases: a commitment made between phases has none
    assert "kzg_commit-5" in raw and "kzg_commit-5" not in depth


@pytest.mark.parametrize("n", [1, 7, 32])
def test_ints_in_of_from_fps_is_the_number_of_values(tracing, n):
    with timer.span("outer"):
        with timer.span("upload"):
            poly = MLPoly.from_fps(BN254_FR, [Fp(i, BN254_FR) for i in range(n)], "cpu")
        with timer.span("download"):
            poly.to_fps()
    upload, download, outer = timer.records()
    assert upload.counters == {"ints_in": n}
    assert download.counters == {"ints_out": n}
    assert outer.counters == {}  # counters are the innermost span's only


def test_counters_go_to_the_innermost_open_span(tracing, monkeypatch):
    monkeypatch.setitem(kernels.LAUNCHES, "msm_bucket_sums", 5)
    with timer.span("outer"):
        kernels.LAUNCHES["msm_bucket_sums"] += 1
        timer.count("ints_in", 3)
        with timer.span("inner"):
            kernels.LAUNCHES["msm_window_sums"] += 2
            limb.from_ints([1, 2], "cpu")
        kernels.LAUNCHES["msm_bucket_sums"] += 4
    inner, outer = timer.records()
    assert inner.counters == {"launches": 2, "ints_in": 2}
    assert outer.counters == {"launches": 5, "ints_in": 3}


def test_a_device_read_counts_card_tensors_only(tracing):
    card = types.SimpleNamespace(is_cuda=True, device="cuda:0")
    host = types.SimpleNamespace(is_cuda=False, device="cpu")
    with timer.span("reads"):
        timer.device_read(card)
        timer.device_read(host)
        timer.device_read(card)
    assert timer.records()[0].counters == {"device_reads": 2}


@pytest.mark.parametrize("action", ["span", "count", "from_ints", "device_read", "launch"])
def test_disabled_tracing_records_and_counts_nothing(monkeypatch, action):
    monkeypatch.setattr(timer, "_enabled", False)
    trace = []
    monkeypatch.setattr(timer, "_trace", trace)
    monkeypatch.setattr(timer, "_card", lambda device: pytest.fail("looked up the card"))
    timer.reset_trace()
    launches = dict(kernels.LAUNCHES)
    with timer.span("off"):
        if action == "count":
            timer.count("ints_in", 4)
        elif action == "from_ints":
            limb.to_ints(limb.from_ints([1, 2, 3], "cpu"))
        elif action == "device_read":
            timer.device_read(types.SimpleNamespace(is_cuda=True, device="cuda"))
        elif action == "launch":
            monkeypatch.setitem(kernels.LAUNCHES, "msm_bucket_sums",
                                kernels.LAUNCHES["msm_bucket_sums"] + 1)
    assert trace == [] and timer.records() == [] and timer._stack == []
    if action != "launch":
        assert kernels.LAUNCHES == launches


class FakeEvent:
    """A CUDA event on a made-up card that runs `lag` seconds behind the
    host: recorded, it takes the host's clock plus the lag then, and it has
    completed unless the card is `behind` the host with work queued."""
    lag = 0.0
    behind = False

    def __init__(self):
        self.t, self.done = None, True

    def record(self, stream):
        self.t = time.perf_counter() + FakeEvent.lag
        self.done = not FakeEvent.behind

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def fake_card(tracing, monkeypatch):
    """A card "cuda" whose events are FakeEvents; returns those made."""
    made = []

    def new_event():
        made.append(FakeEvent())
        return made[-1]

    monkeypatch.setattr(timer, "_new_event", new_event)
    monkeypatch.setattr(timer, "_card", lambda device: (0, None) if device == "cuda" else None)
    monkeypatch.setattr(timer, "_pool", {})
    monkeypatch.setattr(timer, "_origin", None)
    monkeypatch.setattr(timer, "_staged", [])
    monkeypatch.setattr(FakeEvent, "lag", 0.0)
    monkeypatch.setattr(FakeEvent, "behind", False)
    return made


@pytest.mark.parametrize("root", ["stage", "span", "second request"])
def test_a_stage_resolves_to_its_stretch_on_the_card(fake_card, root):
    """Stretches count from the request's first event on the card: the
    root's where it is a stage, else its first stage's."""
    if root == "second request":
        with timer.span("earlier", sync=False, device="cuda"):
            FakeEvent.lag = 0.050
        FakeEvent.lag = 0.0
        time.sleep(0.010)  # an origin taken from the earlier request shows
    as_stage = root != "span"
    with timer.span("root", sync=not as_stage, device="cuda" if as_stage else None):
        FakeEvent.lag = 0.020  # the card runs 20 ms behind the host here
        with timer.span("stage", sync=False, device="cuda"):
            FakeEvent.lag = 0.035
        FakeEvent.lag = 0.0  # a read waits: the card catches up
    *_, stage, top = timer.records()
    origin = top.start if as_stage else stage.start + 0.020
    assert stage.device[0] == pytest.approx(stage.start + 0.020 - origin, abs=2e-3)
    assert stage.device[1] == pytest.approx(stage.end + 0.035 - origin, abs=2e-3)
    if as_stage:
        assert top.device == pytest.approx((0.0, top.seconds), abs=2e-3)
    else:
        assert stage.device[0] == 0.0 and top.device is None


def test_a_stage_waits_for_its_events_before_it_resolves(fake_card):
    with timer.span("root", sync=False, device="cuda"):
        with timer.span("stage", sync=False, device="cuda"):
            pass
    fake_card[-1].done = False  # the request's last event still queued on the card
    assert all(r.device is None for r in timer.records())
    fake_card[-1].done = True
    assert all(r.device is not None for r in timer.records())


@pytest.mark.parametrize("requests,behind", [(2, True), (5, True), (5, False)])
def test_resolved_events_go_back_to_the_pool(fake_card, requests, behind):
    for _ in range(requests):
        with timer.span("root", sync=False, device="cuda"):
            FakeEvent.behind = behind  # the card has not begun the stage
            with timer.span("stage", sync=False, device="cuda"):
                FakeEvent.behind = False
    # where the card is behind, the second request makes three events before
    # its stage's close frees the first request's four, and from then on each
    # request reuses the last's; else they wait for records()
    made = 7 if behind else 4 * requests
    assert len(fake_card) == made
    assert all(r.device is not None for r in timer.records())
    assert len(timer._pool[0]) == made


@pytest.mark.parametrize("root_sync", [True, False])
def test_only_spans_that_synchronise_call_the_system(fake_card, monkeypatch, root_sync):
    calls = []
    real = timer.resource.getrusage
    monkeypatch.setattr(timer.resource, "getrusage", lambda who: calls.append(who) or real(who))
    with timer.span("root", sync=root_sync, device=None if root_sync else "cuda"):
        with timer.span("stage", sync=False, device="cuda"):
            with timer.span("inner stage", sync=False, device="cuda"):
                pass
    assert len(calls) == 2 * root_sync
    inner, stage, root = timer.records()
    assert inner.cpu_s is stage.cpu_s is stage.minor_faults is None
    assert (root.cpu_s is None) is (root.minor_faults is None) is (not root_sync)
