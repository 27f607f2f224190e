"""The port's multilinear polynomials and whole-hypercube evaluator against
the reference (cpp backend): exact equality."""

import numpy as np
import pytest
import torch

from plonkish_tpu.fields import BN254_FR as REF_FR, Fp as RefFp
from plonkish_tpu.piop import evaluator as ref_eval
from plonkish_tpu.poly import multilinear as ref_ml
from plonkish_tpu.utils import expression as ref_ex
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.piop import evaluator
from plonkish_tpu_torch.poly import multilinear as ml
from plonkish_tpu_torch.utils import expression as ex

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = BN254_FR.p


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P for row in words]


def _poly(num_vars, seed):
    ref = ref_ml.MLPoly.from_ints(REF_FR, _ints(1 << num_vars, seed))
    return ml.MLPoly(BN254_FR, convert.digits_to_limbs(ref.evals)), ref


def _eq(ours, ref):
    return torch.equal(ours.evals, convert.digits_to_limbs(ref.evals))


def test_arithmetic_and_folds():
    a, ra = _poly(5, 1)
    b, rb = _poly(5, 2)
    xs = _ints(3, 3)
    assert _eq(a + b, ra + rb)
    assert _eq(a - b, ra - rb)
    assert _eq(a.scale(Fp(xs[0], BN254_FR)), ra.scale(RefFp(xs[0], REF_FR)))
    assert _eq(a.fix_var(Fp(xs[1], BN254_FR)), ra.fix_var(RefFp(xs[1], REF_FR)))
    assert _eq(a.fix_last_vars([Fp(x, BN254_FR) for x in xs]),
               ra.fix_last_vars([RefFp(x, REF_FR) for x in xs]))
    assert [int(v) for v in a.to_fps()] == [int(v) for v in ra.to_fps()]
    assert len(a) == 32 and a.num_vars == 5


@pytest.mark.parametrize("rotation", [0, -1, 1, 2])
def test_evaluate_and_rotations(rotation):
    a, ra = _poly(6, 4)
    point = _ints(6, 5)
    x = [Fp(v, BN254_FR) for v in point]
    rx = [RefFp(v, REF_FR) for v in point]
    assert int(a.evaluate(x)) == int(ra.evaluate(rx))
    rot = ex.Rotation(rotation)
    got = a.evaluate_for_rotation(x, rot)
    want = ra.evaluate_for_rotation(rx, ref_ex.Rotation(rotation))
    assert [int(v) for v in got] == [int(v) for v in want]
    assert int(ml.rotation_eval(x, rot, got)) == int(ref_ml.rotation_eval(rx, ref_ex.Rotation(rotation), want))


@pytest.mark.parametrize("rotation", [-4, -2, -1, 1, 3])
def test_rotations_batched_over_polynomials(rotation):
    """evaluate_for_rotations (every polynomial and pattern in one fold pass
    per variable) gives each polynomial the reference's partial evaluations."""
    pairs = [_poly(6, 20 + i) for i in range(3)]
    point = _ints(6, 6)
    got = ml.evaluate_for_rotations([a for a, _ in pairs], [Fp(v, BN254_FR) for v in point],
                                    ex.Rotation(rotation))
    for values, (_, ra) in zip(got, pairs):
        want = ra.evaluate_for_rotation([RefFp(v, REF_FR) for v in point], ref_ex.Rotation(rotation))
        assert [int(v) for v in values] == [int(v) for v in want]


def test_eq_xy_and_identity():
    y = _ints(5, 6)
    ours = ml.eq_xy(BN254_FR, [Fp(v, BN254_FR) for v in y], "cpu")
    assert _eq(ours, ref_ml.eq_xy(REF_FR, [RefFp(v, REF_FR) for v in y]))
    assert torch.equal(evaluator.identity_table(BN254_FR, 5, "cpu"),
                       convert.digits_to_limbs(ref_eval.identity_table(REF_FR, 5)))


def test_evaluate_on_hypercube():
    num_vars = 4
    pairs = [_poly(num_vars, 10 + i) for i in range(3)]
    ch = _ints(1, 7)

    def build(m):
        p = [m.Polynomial(m.Query(i, m.Rotation(r))) for i, r in ((0, 0), (1, 1), (2, -1))]
        return (p[0] * p[1] + m.Challenge(0) * p[2] - m.identity()) * m.lagrange(1) + p[2]

    got = evaluator.evaluate_on_hypercube(
        BN254_FR, build(ex), num_vars, [p.evals for p, _ in pairs],
        [Fp(ch[0], BN254_FR)], "cpu")
    want = ref_eval.evaluate_on_hypercube(
        REF_FR, build(ref_ex), num_vars, [r.evals for _, r in pairs], [RefFp(ch[0], REF_FR)])
    assert torch.equal(got, convert.digits_to_limbs(want))
