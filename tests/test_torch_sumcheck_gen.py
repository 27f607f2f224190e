"""K3's generator (kernels/sumcheck_gen.py): the generated source depends on
the expression's structure and never on the constants' values, and a whole
zero-check driven through the generated source (built with g++) gives the
round messages of the reference's EvaluationsProver on the cpp backend.
Exact equality."""

import random

import numpy as np
import pytest
import torch

from plonkish_tpu.fields import BN254_FR as REF_FR, Fp as RefFp
from plonkish_tpu.models import circuits as ref_circuits
from plonkish_tpu.piop import sum_check as ref_sc
from plonkish_tpu.poly.multilinear import MLPoly as RefMLPoly
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.kernels import sumcheck as ksc
from plonkish_tpu_torch.kernels import build, sumcheck_gen
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.piop import sum_check as sc
from plonkish_tpu_torch.poly.multilinear import MLPoly

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = BN254_FR.p
EXPRESSIONS = {
    "vanilla": "vanilla_plonk_expression",
    "lookup": "vanilla_plonk_with_lookup_expression",
}


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P for row in words]


def _prover(name, num_vars, seed, challenges):
    expr = getattr(circuits, EXPRESSIONS[name])(BN254_FR, num_vars)
    num_polys = 1 + max(q.poly for q in expr.used_query())
    polys = [MLPoly.from_ints(BN254_FR, _ints(1 << num_vars, seed + i), "cpu")
             for i in range(num_polys)]
    vp = sc.VirtualPolynomial(expr, polys, [Fp(c, BN254_FR) for c in challenges],
                              [[Fp(v, BN254_FR) for v in _ints(num_vars, seed + 200)]])
    state = sc.ProverState(BN254_FR, num_vars, Fp.zero(BN254_FR), vp)
    return state, sc.EvaluationsProver(state)


def _tape_args(state, prover):
    t = prover.tape
    return prover.instrs, t.num_regs, t.out_reg, len(state.table_keys), state.degree


@pytest.mark.parametrize("name", ["vanilla", "lookup"])
def test_source_ignores_constant_values(name):
    """Two challenge sets, one structure: byte-identical source and one
    cache key, while the constant tables differ."""
    s1, p1 = _prover(name, 4, 10, _ints(3, 1))
    s2, p2 = _prover(name, 4, 10, _ints(3, 2))
    assert not torch.equal(p1.consts, p2.consts)
    src1 = sumcheck_gen.source(*_tape_args(s1, p1))
    src2 = sumcheck_gen.source(*_tape_args(s2, p2))
    assert src1.encode() == src2.encode()
    assert sumcheck_gen.structure(*_tape_args(s1, p1)) == sumcheck_gen.structure(*_tape_args(s2, p2))
    flags = build.NVCC_FLAGS
    assert sumcheck_gen.digest(src1, flags) == sumcheck_gen.digest(src2, flags)
    # straight-line code on named locals: no switch, no register array
    assert "switch" not in src1 and "regs[" not in src1
    assert f"Fe {', '.join(f'r{j}' for j in range(p1.tape.num_regs))};" in src1


def test_source_rejects_bad_operand():
    state, prover = _prover("vanilla", 3, 20, _ints(3, 3))
    instrs, num_regs, out_reg, tables, degree = _tape_args(state, prover)
    bad = instrs.copy()
    load = np.flatnonzero(bad[:, 0] == 4)[0]
    bad[load, 1] = tables + 1
    with pytest.raises(ValueError, match="bad tape instruction"):
        sumcheck_gen.source(bad, num_regs, out_reg, tables, degree)


@pytest.mark.parametrize("name", ["vanilla", "lookup"])
def test_zero_check_through_generated_twin(name):
    """A k = 5 zero-check, every round through the generated source built
    with g++ and the plain fold between rounds, against the reference."""
    num_vars = 5
    challenges = _ints(3, 300)
    state, prover = _prover(name, num_vars, 50, challenges)
    rexpr = getattr(ref_circuits, EXPRESSIONS[name])(REF_FR, num_vars)
    refs = [RefMLPoly.from_ints(REF_FR, _ints(1 << num_vars, 50 + i))
            for i in range(1 + max(q.poly for q in rexpr.used_query()))]
    rvp = ref_sc.VirtualPolynomial(rexpr, refs, [RefFp(c, REF_FR) for c in challenges],
                                   [[RefFp(v, REF_FR) for v in _ints(num_vars, 250)]])
    rstate = ref_sc.ProverState(REF_FR, num_vars, RefFp.zero(REF_FR), rvp)
    rprover = ref_sc.EvaluationsProver(rstate)
    try:
        kern = sumcheck_gen.twin(*_tape_args(state, prover))
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    rng = random.Random(num_vars)
    for round_ in range(num_vars):
        ids = sc.identity_params(BN254_FR, state.round, state.identity_offset, "cpu")
        sums = ksc.round_launch(kern, None, state.stacked, prover.consts, state.degree, ids)
        got = [int(v) for v in limb.to_canonical_ints(BN254_FR, sums)]
        want = [int(v) for v in rprover.prove_round(rstate).values]
        assert got == want[1:], f"round {round_}"
        ch = rng.randrange(P)
        state.next_round(Fp(5, BN254_FR), Fp(ch, BN254_FR))
        rstate.next_round(RefFp(5, REF_FR), RefFp(ch, REF_FR))
    assert [int(v) for v in state.into_evals()] == [int(v) for v in rstate.into_evals()]



@pytest.mark.parametrize("system,circuit,field", [
    ("protostar", "vanilla", "fr"), ("protostar", "lookup", "fr"),
    ("sangria", "vanilla", "fr"), ("sangria", "lookup", "fr"), ("protostar", "vanilla", "fq"),
])
def test_decider_tapes_through_generated_twin(system, circuit, field):
    """The folding deciders' tapes (over Fr, and Protostar's over Fq, the
    field of the IPA path) fit the generated kernel: every round of a k = 4
    decider sum-check through the source built with g++ equals the plain
    version, with the plain fold between rounds."""
    from plonkish_tpu_torch.fields.spec import BN254_FQ
    from test_torch_protostar import decider_state

    spec = BN254_FR if field == "fr" else BN254_FQ
    num_vars = 4
    state, prover = decider_state(spec, system, circuit, num_vars, "cpu", 11)
    try:
        kern = sumcheck_gen.twin(*_tape_args(state, prover), spec=spec)
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    t = prover.tape
    for round_ in range(num_vars):
        ids = sc.identity_params(spec, state.round, state.identity_offset, "cpu")
        got = ksc.round_launch(kern, None, state.stacked, prover.consts, state.degree, ids)
        want = ksc.sumcheck_round_plain(spec, state.stacked, prover.instrs, prover.consts,
                                        t.num_regs, t.out_reg, state.degree, ids)
        assert torch.equal(got, want), f"round {round_}"
        state.next_round(Fp(5, spec), Fp(1000 + round_, spec))


def _benchmark_circuit_expression(pkg, name):
    """The zero-check expression (compose) of a benchmark circuit of package
    `pkg`: the aggregation ladder at k = 4 or one sha256 block at k = 8 (the
    expression does not depend on k or the witness)."""
    import importlib

    spec = importlib.import_module(f"{pkg}.fields.spec").BN254_FR
    compose = importlib.import_module(f"{pkg}.backend.hyperplonk.preprocessor").compose
    if name == "aggregation":
        info, _ = importlib.import_module(f"{pkg}.models.aggregation").rand_aggregation_circuit(
            spec, 4, random.Random(1), random.Random(2))
    else:
        info, _, _ = importlib.import_module(f"{pkg}.models.sha256").sha256_circuit(b"abc")
    return compose(info)[1]


@pytest.mark.parametrize("name", ["aggregation", "sha256"])
def test_benchmark_circuit_zero_checks_through_generated_twin(name):
    """The zero-check tapes of the aggregation and sha256 circuits through the
    generated source built with g++: every round of a k = 4 zero-check on
    random tables equals the reference's EvaluationsProver on cpp, the plain
    fold between rounds."""
    num_vars = 4  # sha256 rotates by up to 4 rows
    challenges = _ints(3, 400)
    expr = _benchmark_circuit_expression("plonkish_tpu_torch", name)
    rexpr = _benchmark_circuit_expression("plonkish_tpu", name)
    num_polys = 1 + max(q.poly for q in expr.used_query())
    polys = [MLPoly.from_ints(BN254_FR, _ints(1 << num_vars, 60 + i), "cpu")
             for i in range(num_polys)]
    refs = [RefMLPoly.from_ints(REF_FR, _ints(1 << num_vars, 60 + i)) for i in range(num_polys)]
    y = _ints(num_vars, 450)
    state = sc.ProverState(BN254_FR, num_vars, Fp.zero(BN254_FR), sc.VirtualPolynomial(
        expr, polys, [Fp(c, BN254_FR) for c in challenges], [[Fp(v, BN254_FR) for v in y]]))
    prover = sc.EvaluationsProver(state)
    rstate = ref_sc.ProverState(REF_FR, num_vars, RefFp.zero(REF_FR), ref_sc.VirtualPolynomial(
        rexpr, refs, [RefFp(c, REF_FR) for c in challenges], [[RefFp(v, REF_FR) for v in y]]))
    rprover = ref_sc.EvaluationsProver(rstate)
    try:
        kern = sumcheck_gen.twin(*_tape_args(state, prover))
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    rng = random.Random(num_vars)
    for round_ in range(num_vars):
        ids = sc.identity_params(BN254_FR, state.round, state.identity_offset, "cpu")
        sums = ksc.round_launch(kern, None, state.stacked, prover.consts, state.degree, ids)
        got = [int(v) for v in limb.to_canonical_ints(BN254_FR, sums)]
        want = [int(v) for v in rprover.prove_round(rstate).values]
        assert got == want[1:], f"round {round_}"
        ch = rng.randrange(P)
        state.next_round(Fp(5, BN254_FR), Fp(ch, BN254_FR))
        rstate.next_round(RefFp(5, REF_FR), RefFp(ch, REF_FR))


def test_wide_tapes_keep_their_registers_in_a_local_array():
    """A tape of more than REGFILE_ABOVE registers (the sha256 zero-check's
    185) is written over a local register file; a narrow one over named
    locals."""
    expr = _benchmark_circuit_expression("plonkish_tpu_torch", "sha256")
    num_vars = 4
    polys = [MLPoly.from_ints(BN254_FR, _ints(1 << num_vars, i), "cpu")
             for i in range(1 + max(q.poly for q in expr.used_query()))]
    state = sc.ProverState(BN254_FR, num_vars, Fp.zero(BN254_FR), sc.VirtualPolynomial(
        expr, polys, [Fp(c, BN254_FR) for c in _ints(3, 7)],
        [[Fp(v, BN254_FR) for v in _ints(num_vars, 8)]]))
    prover = sc.EvaluationsProver(state)
    assert prover.tape.num_regs > sumcheck_gen.REGFILE_ABOVE
    src = sumcheck_gen.source(*_tape_args(state, prover))
    assert f"Fe file[{prover.tape.num_regs}];" in src and "sc_regfile(file)" in src
    narrow_state, narrow = _prover("vanilla", 3, 20, _ints(3, 3))
    assert "sc_regfile" not in sumcheck_gen.source(*_tape_args(narrow_state, narrow))


def _fused_buffers(state, prover, pending_seed):
    """A DeviceFsRun's buffers for `state` (its sponge from a transcript
    with bytes pending) and a copy of them."""
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    tr = Keccak256Transcript(state.spec)
    tr.state.update(bytes(random.Random(pending_seed).getrandbits(8) for _ in range(200)))
    run = sc.DeviceFsRun(state, prover, tr)
    names = ("ids", "rows", "sponge", "scal", "fixed", "out", "ch_mont")
    return [{n: getattr(run, n).clone() for n in names} for _ in range(2)]


def _single_leaf(num_vars, seed):
    from plonkish_tpu_torch.utils import expression as ex

    vp = sc.VirtualPolynomial(ex.Polynomial(ex.Query(0, ex.Rotation(0))),
                              [MLPoly.from_ints(BN254_FR, _ints(1 << num_vars, seed), "cpu")],
                              [], [])
    state = sc.ProverState(BN254_FR, num_vars, Fp(7, BN254_FR), vp)
    return state, sc.EvaluationsProver(state)


@pytest.mark.parametrize("name,num_vars", [("vanilla", 6), ("vanilla", 10), ("lookup", 5),
                                            ("single_leaf", 9)])
def test_fused_rounds_through_generated_twin(name, num_vars):
    """K7 of the generated source built with g++ (phase (a) warp by warp on
    3 resident blocks of 4 warps, then (b), then (c)) against its plain
    version: every round from the first, and the rounds from round 2 on
    after two plain ones; the messages, challenges, sponge words, sums,
    identity rows and final tables equal.  A set of pairs is 32 pairs, so the
    vanilla tape at k = 10 (512 pairs) keeps two sets of five warps (a t
    each) live through grid-stride turns, one set of eight in its last
    rounds; the single leaf at k = 9 keeps a set on every warp."""
    if name == "single_leaf":
        state, prover = _single_leaf(num_vars, 70)
    else:
        state, prover = _prover(name, num_vars, 80, _ints(3, 500))
    try:
        kern = sumcheck_gen.twin(*_tape_args(state, prover))
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    assert (kern.fused.warps, kern.fused.resident) == (4, 3)
    t = prover.tape
    order = ("ids", "rows", "sponge", "scal", "fixed", "out", "ch_mont")
    for first in (0, 2):
        twin_bufs, plain_bufs = _fused_buffers(state, prover, 40 + first)
        stacked = state.stacked
        if first:
            stacked = ksc.fused_rounds_plain(BN254_FR, stacked, prover.instrs, prover.consts,
                                             t.num_regs, t.out_reg, state.degree,
                                             *(plain_bufs[n] for n in order), 0, first)
            twin_bufs = {n: v.clone() for n, v in plain_bufs.items()}
        rounds = num_vars - first
        got = ksc.fused_launch(kern, None, BN254_FR, stacked.clone(), prover.consts,
                               state.degree, *(twin_bufs[n] for n in order), first, rounds)
        want = ksc.fused_rounds_plain(BN254_FR, stacked.clone(), prover.instrs, prover.consts,
                                      t.num_regs, t.out_reg, state.degree,
                                      *(plain_bufs[n] for n in order), first, rounds)
        assert got.shape == (stacked.shape[0], 1, 8) and torch.equal(got, want), first
        for n in order:
            assert torch.equal(twin_bufs[n], plain_bufs[n]), (first, n)


def _three_tables(pkg_ex):
    """P0 * P1 + P2 over the expression module `pkg_ex` of either package: 3
    tables, a count that does not divide the twin's cluster of 4."""
    P = lambda i: pkg_ex.Polynomial(pkg_ex.Query(i, pkg_ex.Rotation(0)))  # noqa: E731
    return P(0) * P(1) + P(2)


def _both_provers(name, num_vars, seed):
    """The port's (state, prover) and the JAX package's (state, prover) of
    one Evaluations sum-check on the same tables, challenges and y."""
    from plonkish_tpu.utils import expression as ref_ex
    from plonkish_tpu_torch.utils import expression as ex

    challenges = _ints(3, seed + 100)
    if name == "three_tables":
        expr, rexpr = _three_tables(ex), _three_tables(ref_ex)
    else:
        expr = getattr(circuits, EXPRESSIONS[name])(BN254_FR, num_vars)
        rexpr = getattr(ref_circuits, EXPRESSIONS[name])(REF_FR, num_vars)
    count = 1 + max(q.poly for q in expr.used_query())
    y = _ints(num_vars, seed + 200)
    state = sc.ProverState(BN254_FR, num_vars, Fp.zero(BN254_FR), sc.VirtualPolynomial(
        expr, [MLPoly.from_ints(BN254_FR, _ints(1 << num_vars, seed + i), "cpu")
               for i in range(count)],
        [Fp(c, BN254_FR) for c in challenges], [[Fp(v, BN254_FR) for v in y]]))
    rstate = ref_sc.ProverState(REF_FR, num_vars, RefFp.zero(REF_FR), ref_sc.VirtualPolynomial(
        rexpr,
        [RefMLPoly.from_ints(REF_FR, _ints(1 << num_vars, seed + i)) for i in range(count)],
        [RefFp(c, REF_FR) for c in challenges], [[RefFp(v, REF_FR) for v in y]]))
    return state, sc.EvaluationsProver(state), rstate, ref_sc.EvaluationsProver(rstate)


@pytest.mark.parametrize("name,num_vars,where", [
    ("vanilla", 4, "tail_from_round_0"),       # 8 pairs, two a block: the cluster from round 0
    ("vanilla", 8, "tail_mid_way"),            # grid 128..32, the tail from 16
    ("three_tables", 7, "tables_not_dividing_cluster"),  # a cluster of 4 from 64 pairs
    ("vanilla", 2, "one_block_from_the_start"),  # 2 pairs: fewer than two a block
    ("lookup", 6, "lookup_degree"),            # cap 2, a cluster of 2 from 4 pairs
])
def test_fused_tail_through_generated_twin(name, num_vars, where):
    """K7's grid rounds and cluster tail of the generated source built with
    g++ (the tail on 4 blocks of 2 warps with 4 KB of state each, so that the
    handover, the cluster's rounds and block 0's gather of the last rounds
    fall within a few rounds) against the plain K3 -> K6 -> K4 rounds in every buffer, and
    every round's message against the JAX package's EvaluationsProver on the
    cpp backend (t = 1..d), driven with the twin's challenges.  The grid kernel launches
    only where the first round's pairs exceed the handover; the tail once."""
    from plonkish_tpu_torch.kernels import LAUNCHES

    state, prover, rstate, rprover = _both_provers(name, num_vars, 90)
    try:
        kern = sumcheck_gen.twin(*_tape_args(state, prover))
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    assert (kern.tail.warps, kern.tail.cluster) == (2, 4)
    tables, degree = state.stacked.shape[0], state.degree
    cluster, cap, handover = ksc.tail_plan(kern.tail, tables, degree)
    assert cap * tables * ksc.PAIR_BYTES <= 4096 < 2 * cap * tables * ksc.PAIR_BYTES
    s0 = 1 << (num_vars - 1)
    assert (where == "one_block_from_the_start") == (s0 < 2 * cluster)
    assert (where == "tail_mid_way" or name == "lookup") == (s0 > handover)
    order = ("ids", "rows", "sponge", "scal", "fixed", "out", "ch_mont")
    twin_bufs, plain_bufs = _fused_buffers(state, prover, 60)
    before = dict(LAUNCHES)
    t = prover.tape
    got = ksc.fused_launch(kern, None, BN254_FR, state.stacked.clone(), prover.consts, degree,
                           *(twin_bufs[n] for n in order), 0, num_vars)
    assert LAUNCHES["sumcheck_fused"] - before["sumcheck_fused"] == int(s0 > handover)
    assert LAUNCHES["sumcheck_fused_tail"] - before["sumcheck_fused_tail"] == 1
    want = ksc.fused_rounds_plain(BN254_FR, state.stacked.clone(), prover.instrs, prover.consts,
                                  t.num_regs, t.out_reg, degree,
                                  *(plain_bufs[n] for n in order), 0, num_vars)
    assert torch.equal(got, want)
    for n in order:
        assert torch.equal(twin_bufs[n], plain_bufs[n]), n
    # the message at t = 1..d (t = 0 is the claimed sum less t = 1's)
    rows = limb.to_ints(twin_bufs["out"])
    for r in range(num_vars):
        row = rows[r * (degree + 2): (r + 1) * (degree + 2)]
        assert [int(v) for v in rprover.prove_round(rstate).values][1:] == row[1: degree + 1], r
        rstate.next_round(RefFp(5, REF_FR), RefFp(row[degree + 1], REF_FR))


def test_ptxas_lines_name_each_build_of_the_grid_kernel():
    """The grid kernel is built capped and uncapped: each build's ptxas lines
    carry its name, the tail's and the out-of-line helpers' theirs."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN2pk22sc_fused_kernel_cappedINS_4TapeEEEvNS_7ScFusedE' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN2pk22sc_fused_kernel_cappedINS_4TapeEEEvNS_7ScFusedE",
        "    16 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 8448 bytes smem",
        "ptxas info    : Compiling entry function "
        "'_ZN2pk15sc_fused_kernelINS_4TapeEEEvNS_7ScFusedE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN2pk15sc_fused_kernelINS_4TapeEEEvNS_7ScFusedE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 180 registers, used 1 barriers, 8448 bytes smem",
        "ptxas info    : Function properties for _ZN2pk6sc_mulINS_2FrEEENS_2FeES2_S2_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function "
        "'_ZN2pk14sc_tail_kernelINS_4TapeEEEvNS_7ScFusedE' for 'sm_90a'",
        "ptxas info    : Used 230 registers, used 1 barriers, 7680 bytes smem",
    ])
    grid = sumcheck_gen._kernel_ptxas(log, "sc_fused_kernel")
    assert "sc_fused_kernel_capped: 16 bytes stack frame, 20 bytes spill stores" in grid
    assert "sc_fused_kernel: 0 bytes stack frame, 0 bytes spill stores" in grid
    assert "sc_fused_kernel: Used 180 registers" in grid and "sc_mul: 0 bytes" in grid
    assert "sc_tail_kernel" not in grid
    assert sumcheck_gen._kernel_ptxas(log, "sc_tail_kernel").endswith(
        "sc_tail_kernel: Used 230 registers, used 1 barriers, 7680 bytes smem")
