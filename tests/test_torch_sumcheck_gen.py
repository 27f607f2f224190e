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
