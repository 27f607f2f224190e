"""Sum-check rounds through the plain versions of K3 (round evaluations) and
K4 (fold) against the reference's EvaluationsProver, MLPoly.fix_var and
ClassicSumCheck on the cpp backend.  Exact equality."""

import random

import numpy as np
import pytest
import torch

from plonkish_tpu.fields import BN254_FR as REF_FR, Fp as RefFp
from plonkish_tpu.models import circuits as ref_circuits
from plonkish_tpu.piop import sum_check as ref_sc
from plonkish_tpu.poly.multilinear import MLPoly as RefMLPoly
from plonkish_tpu.utils import expression as ref_ex
from plonkish_tpu.utils.transcript import Keccak256Transcript as RefTranscript
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.kernels import sumcheck as ksc
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.piop import sum_check as sc
from plonkish_tpu_torch.poly.multilinear import MLPoly
from plonkish_tpu_torch.utils import expression as ex
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = BN254_FR.p


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P for row in words]


def _pair(num_polys, num_vars, seed):
    """The same random polynomials in both packages."""
    ref = [RefMLPoly.from_ints(REF_FR, _ints(1 << num_vars, seed + i)) for i in range(num_polys)]
    ours = [MLPoly(BN254_FR, convert.digits_to_limbs(p.evals)) for p in ref]
    return ours, ref


def _vp_pair(expr_ours, expr_ref, num_vars, seed, num_challenges=3):
    num_polys = 1 + max(q.poly for q in expr_ours.used_query())
    ours, ref = _pair(num_polys, num_vars, seed)
    ch = _ints(num_challenges, seed + 100)
    y = _ints(num_vars, seed + 200)
    vp = sc.VirtualPolynomial(expr_ours, ours, [Fp(c, BN254_FR) for c in ch],
                              [[Fp(v, BN254_FR) for v in y]])
    rvp = ref_sc.VirtualPolynomial(expr_ref, ref, [RefFp(c, REF_FR) for c in ch],
                                   [[RefFp(v, REF_FR) for v in y]])
    return vp, rvp


EXPRESSIONS = {
    "vanilla": "vanilla_plonk_expression",
    "lookup": "vanilla_plonk_with_lookup_expression",
}


@pytest.mark.parametrize("num_vars", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("name", ["vanilla", "lookup"])
def test_round_evals_match_reference(name, num_vars):
    fn = EXPRESSIONS[name]
    expr = getattr(circuits, fn)(BN254_FR, num_vars)
    rexpr = getattr(ref_circuits, fn)(REF_FR, num_vars)
    vp, rvp = _vp_pair(expr, rexpr, num_vars, 10 * num_vars)
    state = sc.ProverState(BN254_FR, num_vars, Fp.zero(BN254_FR), vp)
    rstate = ref_sc.ProverState(REF_FR, num_vars, RefFp.zero(REF_FR), rvp)
    prover = sc.EvaluationsProver(state)
    rprover = ref_sc.EvaluationsProver(rstate)
    rng = random.Random(num_vars)
    for round_ in range(num_vars):
        got = [int(v) for v in prover.prove_round(state).values]
        want = [int(v) for v in rprover.prove_round(rstate).values]
        assert got == want, f"round {round_}"
        ch = rng.randrange(P)
        state.next_round(Fp(5, BN254_FR), Fp(ch, BN254_FR))
        rstate.next_round(RefFp(5, REF_FR), RefFp(ch, REF_FR))
    assert [int(v) for v in state.into_evals()] == [int(v) for v in rstate.into_evals()]


def test_single_leaf_degree_one():
    """One leaf, degree 1: sum_b hi(b) per round, against Python ints (the
    reduction's digit weights must all be right)."""
    num_vars = 5
    vals = _ints(1 << num_vars, 77)
    poly = MLPoly.from_ints(BN254_FR, vals, "cpu")
    leaf = ex.Polynomial(ex.Query(0, ex.Rotation(0)))
    vp = sc.VirtualPolynomial(leaf, [poly], [], [])
    state = sc.ProverState(BN254_FR, num_vars, Fp(sum(vals) % P, BN254_FR), vp)
    prover = sc.EvaluationsProver(state)
    msg = prover.prove_round(state)
    assert int(msg.values[1]) == sum(vals[1::2]) % P
    assert int(msg.values[0]) == sum(vals[0::2]) % P


def test_fold_matches_fix_var():
    ours, ref = _pair(3, 6, 500)
    stacked = torch.stack([p.evals for p in ours])
    x = 0xDEADBEEF12345
    got = ksc.fold_plain(BN254_FR, stacked, limb.const(BN254_FR, x))
    for i, rp in enumerate(ref):
        want = rp.fix_var(RefFp(x, REF_FR)).evals
        assert torch.equal(got[i], convert.digits_to_limbs(want))
    assert torch.equal(ksc.fold(BN254_FR, stacked, limb.const(BN254_FR, x)), got)


def test_classic_sum_check_transcript_evaluations():
    num_vars = 4
    expr = circuits.vanilla_plonk_expression(BN254_FR, num_vars)
    rexpr = ref_circuits.vanilla_plonk_expression(REF_FR, num_vars)
    vp, rvp = _vp_pair(expr, rexpr, num_vars, 900)
    t, rt = Keccak256Transcript(BN254_FR), RefTranscript(REF_FR)
    t.write_field_element(Fp(3, BN254_FR))
    rt.write_field_element(RefFp(3, REF_FR))
    x, evals = sc.ClassicSumCheck.evaluations().prove(BN254_FR, num_vars, vp, Fp.zero(BN254_FR), t)
    rx, revals = ref_sc.ClassicSumCheck.evaluations().prove(REF_FR, num_vars, rvp, RefFp.zero(REF_FR), rt)
    assert t.into_proof() == rt.into_proof()
    assert [int(v) for v in x] == [int(v) for v in rx]
    assert [int(v) for v in evals] == [int(v) for v in revals]


def test_classic_sum_check_transcript_coefficients():
    """The degree-2 batch-open rounds (CoefficientsProver)."""
    num_vars = 5
    scal = [3, 5]

    def build(mod, F):
        e = None
        for i, s in enumerate(scal):
            term = mod.eq_xy(i) * mod.Polynomial(mod.Query(i, mod.Rotation(0))) * F(s)
            e = term if e is None else e + term
        return e

    expr = build(ex, lambda v: Fp(v, BN254_FR))
    rexpr = build(ref_ex, lambda v: RefFp(v, REF_FR))
    ours, ref = _pair(2, num_vars, 1234)
    ys = [_ints(num_vars, 5000), _ints(num_vars, 6000)]
    vp = sc.VirtualPolynomial(expr, ours, [], [[Fp(v, BN254_FR) for v in y] for y in ys])
    rvp = ref_sc.VirtualPolynomial(rexpr, ref, [], [[RefFp(v, REF_FR) for v in y] for y in ys])
    claim = _ints(1, 42)[0]
    t, rt = Keccak256Transcript(BN254_FR), RefTranscript(REF_FR)
    x, evals = sc.ClassicSumCheck.coefficients().prove(BN254_FR, num_vars, vp, Fp(claim, BN254_FR), t)
    rx, revals = ref_sc.ClassicSumCheck.coefficients().prove(REF_FR, num_vars, rvp, RefFp(claim, REF_FR), rt)
    assert t.into_proof() == rt.into_proof()
    assert [int(v) for v in evals] == [int(v) for v in revals]
    # and the port's verifier reads the same messages
    r = Keccak256Transcript.from_proof(BN254_FR, t.into_proof())
    _, xs = sc.ClassicSumCheck.coefficients().verify(BN254_FR, num_vars, 2, Fp(claim, BN254_FR), r)
    assert [int(v) for v in xs] == [int(v) for v in x]
