"""K7, the fused sum-check rounds (kernels/sumcheck.py ``fused_rounds``, taken
by piop/sum_check.py ``DeviceFsRun`` under ``config.fused_rounds()``), on
CPU tensors, where it runs its plain version ``fused_rounds_plain``.

The device transcript is selected as tests/test_torch_device_fs.py selects
it (the rule patched to take every eligible prover); with
PLONKISH_TPU_FUSED_ROUNDS=1 each case's challenges, round messages (the
transcript's bytes) and final evaluations must equal those of the host loop
and of the per-round device path (the flag at 0), from sponges with 0, 32,
80 and 120 bytes pending, with the handover at every round and at a middle
one.  The flag and the identity stack are held against the JAX package's.
Exact equality throughout.  The module imports the port only (the JAX
package inside the tests that read it), so the gloo ranks re-import it
without JAX.
"""

import random

import numpy as np
import pytest
import torch

from plonkish_tpu_torch import config, parallel
from plonkish_tpu_torch.accumulation.protostar import ProtostarStrategy, protostar_expressions
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
from plonkish_tpu_torch.kernels import sumcheck as ksc
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.piop import sum_check as sc
from plonkish_tpu_torch.poly.multilinear import MLPoly
from plonkish_tpu_torch.utils import expression as ex
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

torch.set_num_threads(1)

PENDING = (0, 32, 80, 120)
PLAIN = ksc.fused_rounds_plain


def _polys(spec, k, count, rng):
    return [MLPoly.from_ints(spec, [rng.randrange(spec.p) for _ in range(1 << k)], "cpu")
            for _ in range(count)]


def _virtual(spec, k, expr, extra_challenges, seed):
    """A virtual polynomial of `expr` over random tables, challenges and y."""
    rng = random.Random(seed)
    polys = _polys(spec, k, 1 + max(q.poly for q in expr.used_query()), rng)
    ch = [Fp(rng.randrange(spec.p), spec) for _ in range(3 + extra_challenges)]
    y = [Fp(rng.randrange(spec.p), spec) for _ in range(k)]
    return sc.VirtualPolynomial(expr, polys, ch, [y]), Fp(rng.randrange(spec.p), spec)


def case(name, k, seed=21):
    """(spec, virtual polynomial, claimed sum) of one Evaluations sum-check."""
    if name in ("vanilla", "vanilla_fq"):
        spec = BN254_FQ if name == "vanilla_fq" else BN254_FR
        return (spec, *_virtual(spec, k, circuits.vanilla_plonk_expression(spec, k), 0, seed))
    if name == "lookup":
        expr = circuits.vanilla_plonk_with_lookup_expression(BN254_FR, k)
        return (BN254_FR, *_virtual(BN254_FR, k, expr, 0, seed))
    if name == "single_leaf":
        expr = ex.Polynomial(ex.Query(0, ex.Rotation(0)))
        return (BN254_FR, *_virtual(BN254_FR, k, expr, 0, seed))
    assert name == "protostar_decider"
    info, _ = circuits.rand_vanilla_plonk_circuit(BN254_FR, 4, random.Random(42),
                                                  random.Random(0))
    exprs = protostar_expressions(info, ProtostarStrategy.Compressing)
    # the folded challenges and u, then beta, gamma and alpha
    return (BN254_FR, *_virtual(BN254_FR, k, exprs.expression,
                                exprs.num_folding_challenges + 1, seed))


def transcript(spec, pending, seed):
    """A transcript after a permutation, with `pending` bytes buffered."""
    rng = random.Random(seed)
    tr = Keccak256Transcript(spec)
    for _ in range(5):
        tr.common_field_element(Fp(rng.randrange(spec.p), spec))
    tr.squeeze_challenge()  # 32 pending
    tr.state.update(bytes(rng.getrandbits(8) for _ in range((pending - 32) % 136)))
    assert len(tr.export_sponge()[1]) == pending
    return tr


def prove(spec, k, vp, sum_, pending, path, monkeypatch, handover=None):
    """(challenges, final evaluations, transcript bytes, K7's (first, rounds)
    calls) of one sum-check by `path`: "host" (the host loop), "per_round"
    (the device path with the flag at 0) or "fused" (the flag at 1, the
    handover at `handover` pairs, None for every round)."""
    calls = []

    def spy(*args):
        calls.append(tuple(args[-2:]))
        return PLAIN(*args)

    monkeypatch.setattr(ksc, "fused_rounds_plain", spy)
    monkeypatch.setattr(sc, "FUSED_MAX_PAIRS", handover)
    monkeypatch.setenv("PLONKISH_TPU_FUSED_ROUNDS", "0" if path == "per_round" else "1")
    monkeypatch.setattr(sc, "device_fs_selected",
                        (lambda state, prover: False) if path == "host"
                        else (lambda state, prover: sc.device_fs_eligible(prover)))
    tr = transcript(spec, pending, 7 + pending)
    challenges, evals = sc.ClassicSumCheck.evaluations().prove(spec, k, vp, sum_, tr)
    return challenges, evals, tr.into_proof(), calls


@pytest.mark.parametrize("name,k", [("vanilla", 5), ("vanilla", 6), ("lookup", 5),
                                    ("single_leaf", 5), ("protostar_decider", 5),
                                    ("vanilla_fq", 5)])
@pytest.mark.parametrize("handover", ["every_round", "middle"])
def test_fused_equals_host_loop_and_per_round(name, k, handover, monkeypatch):
    """Challenges, messages and final evaluations of K7's plain run equal the
    host loop's and the per-round device path's; K7 took the rounds from the
    handover on, in one call."""
    spec, vp, sum_ = case(name, k)
    pairs = None if handover == "every_round" else 1 << (k // 2)
    first = 0 if pairs is None else k - 1 - k // 2
    for pending in PENDING:
        host = prove(spec, k, vp, sum_, pending, "host", monkeypatch)
        per_round = prove(spec, k, vp, sum_, pending, "per_round", monkeypatch)
        fused = prove(spec, k, vp, sum_, pending, "fused", monkeypatch, pairs)
        assert host[:3] == per_round[:3] == fused[:3], (pending, name)
        assert host[3] == per_round[3] == [] and fused[3] == [(first, k - first)], pending


def test_fused_run_advances_every_buffer_as_the_per_round_path():
    """One DeviceFsRun's buffers after the rounds (sponge, sum and offset,
    messages, challenge, identity rows, final tables) are the same with the
    flag at 1 as at 0."""
    spec, vp, sum_ = case("lookup", 5, seed=3)
    runs = {}
    for flag in ("0", "1"):
        state = sc.ProverState(spec, 5, sum_, vp)
        prover = sc.EvaluationsProver(state)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PLONKISH_TPU_FUSED_ROUNDS", flag)
            run = sc.DeviceFsRun(state, prover, transcript(spec, 80, 1))
            run.enqueue()
        runs[flag] = [run.sponge, run.scal, run.out, run.ch_mont, run.ids, state.stacked]
        assert state.round == 5
    for a, b in zip(*runs.values()):
        assert torch.equal(a, b)


def test_coefficients_sum_check_keeps_its_rounds(monkeypatch):
    """The Coefficients (batch-open) sum-check never takes K7."""
    from test_torch_device_fs import batch_open_case

    vp, sum_ = batch_open_case(5)
    monkeypatch.setenv("PLONKISH_TPU_FUSED_ROUNDS", "1")
    monkeypatch.setattr(ksc, "fused_rounds_plain", lambda *a: pytest.fail("K7 was taken"))
    state = sc.ProverState(BN254_FR, 5, sum_, vp)
    run = sc.DeviceFsRun(state, sc.CoefficientsProver(state), Keccak256Transcript(BN254_FR))
    assert not run.fused
    run.enqueue()


def test_fused_launch_refuses_what_it_cannot_run():
    spec, vp, sum_ = case("vanilla", 4)
    state = sc.ProverState(spec, 4, sum_, vp)
    prover = sc.EvaluationsProver(state)
    run = sc.DeviceFsRun(state, prover, Keccak256Transcript(spec))
    kern = type("K", (), {"degree": state.degree + 1})()
    args = (prover.consts, state.degree, run.ids, run.rows, run.sponge, run.scal, run.fixed,
            run.out, run.ch_mont)
    with pytest.raises(ValueError, match="generated for degree"):
        ksc.fused_launch(kern, None, spec, state.stacked, *args, 0, 4)
    kern.degree = state.degree
    with pytest.raises(ValueError, match="outside"):
        ksc.fused_launch(kern, None, spec, state.stacked, *args, 1, 4)
    with pytest.raises(ValueError, match="fold"):
        ksc.fused_launch(kern, None, spec, state.stacked[:, :8].contiguous(), *args, 0, 4)
    with pytest.raises(ValueError, match="state must be a CUDA tensor"):
        ksc.fused_rounds_cuda(spec, state.stacked, prover.instrs, *args[:1], 0, 0, *args[1:],
                              0, 4)


@pytest.mark.parametrize("value", [None, "0", "1", "true", ""])
def test_flag_reads_the_environment_as_the_reference(value, monkeypatch):
    from plonkish_tpu import config as jconfig

    if value is None:
        monkeypatch.delenv("PLONKISH_TPU_FUSED_ROUNDS", raising=False)
        assert config.fused_rounds()
    else:
        monkeypatch.setenv("PLONKISH_TPU_FUSED_ROUNDS", value)
    assert config.fused_rounds() == jconfig.fused_rounds()


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ], ids=["fr", "fq"])
def test_identity_stack_rows_equal_the_reference_round_constants(spec):
    """The mul and step rows of the port's identity stack (what K7 reads by
    round index) equal the JAX package's device stacks of round constants
    (_round_const_stacks, numpy only), for all 32 rounds."""
    from plonkish_tpu.fields import BN254_FQ as REF_FQ, BN254_FR as REF_FR
    from plonkish_tpu.piop.sum_check import _MAX_ROUNDS, _round_const_stacks

    ref = REF_FR if spec is BN254_FR else REF_FQ
    idmul, step = _round_const_stacks(ref)
    rows = limb.to_ints(sc.identity_stack(spec, [0] * _MAX_ROUNDS, "cpu"))

    def digits_to_int(d):
        return sum(int(v) << (16 * i) for i, v in enumerate(np.asarray(d).tolist()))

    for r in range(_MAX_ROUNDS):
        assert rows[3 * r] == digits_to_int(idmul[r]), r
        assert rows[3 * r + 2] == digits_to_int(step[r]), r


def _sharded_rank(mesh, k):
    """One gloo rank: the zero-check at k on this rank's rows by the host
    loop, the per-round device path and K7 after the rows are gathered."""
    from _pytest.monkeypatch import MonkeyPatch

    spec, vp, sum_ = case("vanilla", k)
    mp = MonkeyPatch()
    try:
        out = [prove(spec, k, vp, sum_, 32, path, mp)
               for path in ("host", "per_round", "fused")]
    finally:
        mp.undo()
    assert mesh.taken["sum_check"] == 3
    return out


def test_fused_under_a_two_rank_mesh(monkeypatch):
    """Two gloo ranks: the sharded rounds keep K3 -> all-reduce -> K6 -> K4,
    K7 takes the last round once the rows are gathered, and every rank's
    result equals the unsharded host loop's."""
    k = 4
    spec, vp, sum_ = case("vanilla", k)
    want = prove(spec, k, vp, sum_, 32, "host", monkeypatch)
    monkeypatch.setenv("PLONKISH_TPU_FUSED_ROUNDS", "1")
    results = parallel.spawn(_sharded_rank, 2, "gloo", "cpu", args=(k,), threads=1,
                             deadline_s=300)
    for host, per_round, fused in results:
        assert host[:3] == per_round[:3] == fused[:3] == want[:3]
        assert fused[3] == [(k - 1, 1)]


@pytest.mark.parametrize("tables,degree,cluster,smem,want", [
    (16, 5, 16, 228864, (16, 128, 2048)),   # the vanilla tape on the card's 16-block cluster
    (16, 5, 8, 228864, (8, 128, 1024)),      # ... on 8 blocks
    (297, 3, 16, 228864, (8, 8, 64)),        # the sha256 tape: 8 pairs a block, 8 blocks
    (1, 1, 16, 228864, (16, 2048, 32768)),   # one table
    (3600, 5, 16, 228864, None),             # no pair of every table fits a block
    (16, 5, 4, 4096 + 4 * 5 * 8 * 4, (4, 4, 16)),  # the host twin's small cluster
])
def test_tail_plan_from_tables_and_shared_memory(tables, degree, cluster, smem, want):
    """K7's handover: `cap` pairs of every table in one block's shared memory
    after block 0's partial sums, a cluster of at most `cap` blocks, the
    handover their product."""
    tail = type("Tail", (), {"cluster": cluster, "smem": smem})()
    plan = ksc.tail_plan(tail, tables, degree)
    assert plan == want
    if plan:
        budget = smem - ksc.tail_parts_bytes(cluster, degree)
        assert plan[1] * tables * ksc.PAIR_BYTES <= budget < 2 * plan[1] * tables * ksc.PAIR_BYTES
    two = type("Tail", (), {"cluster": 2, "smem": smem})()  # a library with a cluster of 2
    small = ksc.tail_plan(two, tables, degree)
    assert (small is None) == (plan is None)
    if small:
        assert small[0] == min(2, small[1]) and small[2] == small[0] * small[1]
        assert small[1] >= (plan[1] if plan else 1)  # block 0's partial sums shrink with it


def _twin_run(k, first, rounds, **tail):
    """K7 through the generated source built with g++ (kernels/sumcheck_gen.py
    twin), its tail's launch shape changed by `tail` (TailLaunch fields),
    from round `first` for `rounds` rounds, and its plain version, on the
    vanilla sum-check at k: both results and buffers, and the launches of
    K7's two kernels."""
    import dataclasses

    from plonkish_tpu_torch.kernels import LAUNCHES, sumcheck_gen

    spec, vp, sum_ = case("vanilla", k, seed=5)
    state = sc.ProverState(spec, k, sum_, vp)
    prover = sc.EvaluationsProver(state)
    t = prover.tape
    kern = sumcheck_gen.twin(prover.instrs, t.num_regs, t.out_reg, state.stacked.shape[0],
                             state.degree, spec=spec)
    kern = dataclasses.replace(kern, tail=dataclasses.replace(kern.tail, **tail))
    rows = state.stacked[:, : state.stacked.shape[1] >> first].contiguous()
    runs = []
    for _ in range(2):
        run = sc.DeviceFsRun(state, prover, transcript(spec, 32, 3))
        run.out.zero_()  # the rows before `first` are not written
        runs.append([run.ids, run.rows, run.sponge, run.scal, run.fixed, run.out, run.ch_mont])
    before = dict(LAUNCHES)
    got = ksc.fused_launch(kern, None, spec, rows.clone(), prover.consts, state.degree,
                           *runs[0], first, rounds)
    counts = tuple(LAUNCHES[n] - before[n] for n in ("sumcheck_fused", "sumcheck_fused_tail"))
    want = PLAIN(spec, rows.clone(), prover.instrs, prover.consts, t.num_regs, t.out_reg,
                 state.degree, *runs[1], first, rounds)
    return (got, *runs[0]), (want, *runs[1]), counts, kern


@pytest.mark.parametrize("first,rounds,opts,counts", [
    (0, 6, {}, (1, 1)),                   # 32 pairs: the grid round, then the tail from 16
    (1, 5, {}, (0, 1)),                   # from 16 pairs: the tail alone
    (0, 1, {}, (1, 0)),                   # one round above the handover: the grid alone
    (0, 6, {"smem": 1024}, (1, 0)),       # no pair of every table fits a block: the grid alone
    (0, 6, {"cluster": 2}, (1, 1)),       # a cluster of 2: the grid to 16 pairs, the tail from 8
])
def test_fused_launch_splits_the_rounds_at_the_handover(first, rounds, opts, counts):
    """The wrapper launches K7's grid kernel for the rounds above the
    handover and its tail for the rest, each counted where it launches, and
    every split gives the plain rounds' result in every buffer; `opts`
    change the tail's launch shape as another card's would."""
    try:
        got, want, launched, kern = _twin_run(6, first, rounds, **opts)
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    assert launched == counts
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fused_launch_refuses_stamps_without_the_timing_build():
    """Phase stamps need the measurement build with the timing macro; the
    generator refuses a macro it does not know."""
    from plonkish_tpu_torch.kernels import sumcheck_gen

    try:
        _, _, _, kern = _twin_run(4, 0, 4)
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    spec, vp, sum_ = case("vanilla", 4, seed=5)
    state = sc.ProverState(spec, 4, sum_, vp)
    prover = sc.EvaluationsProver(state)
    run = sc.DeviceFsRun(state, prover, Keccak256Transcript(spec))
    times = torch.zeros((4, ksc.FUSED_PHASES, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="timing macro"):
        ksc.fused_launch(kern, None, spec, state.stacked.clone(), prover.consts, state.degree,
                         run.ids, run.rows, run.sponge, run.scal, run.fixed, run.out,
                         run.ch_mont, 0, 4, times=times)
    t = prover.tape
    with pytest.raises(ValueError, match="unknown measurement macro"):
        sumcheck_gen.source(prover.instrs, t.num_regs, t.out_reg, state.stacked.shape[0],
                            state.degree, spec, defines=(("fast", 1),))
