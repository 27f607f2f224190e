"""MSM through the plain versions of K1 (bucket sums) and K2 (window sums)
against the reference ``variable_base_msm`` on its cpp backend, plus the
fixed-base MSM.  Exact equality of affine points."""

import numpy as np
import pytest
import torch

from plonkish_tpu.curves import msm as ref_msm
from plonkish_tpu.curves.device import from_affine_host as ref_from_affine
from plonkish_tpu.curves.device import to_affine_host as ref_to_affine
from plonkish_tpu.curves.host import AffinePoint as RefAffine
from plonkish_tpu.curves.specs import BN254_G1 as REF_G1
from plonkish_tpu.fields import limb as ref_limb
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.curves import device as cdev
from plonkish_tpu_torch.curves import msm
from plonkish_tpu_torch.curves.host import AffinePoint
from plonkish_tpu_torch.curves.specs import BN254_G1
from plonkish_tpu_torch.fields import limb

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

P = BN254_G1.scalar.p


def _scalars(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % P for row in words]


def _ref_points(n, seed):
    """n reference projective points G * s_i (uint32[n, 3, 16])."""
    return np.asarray(ref_msm.fixed_base_msm(REF_G1, RefAffine.generator(REF_G1), _scalars(n, seed)))


def _same(ours: AffinePoint, theirs: RefAffine) -> bool:
    if ours.is_identity() or theirs.is_identity():
        return ours.is_identity() == theirs.is_identity()
    return (int(ours.x), int(ours.y)) == (int(theirs.x), int(theirs.y))


def _check(points, scalars):
    want = ref_msm.variable_base_msm(REF_G1, scalars, points)
    bases = convert.basis_from_reference(points)
    got = msm.variable_base_msm(BN254_G1, limb.from_ints(scalars), bases)
    assert _same(got, want)


@pytest.mark.parametrize("n", [1, 2, 31, 32, 1000, 4096])
def test_random(n):
    _check(_ref_points(n, n), _scalars(n, n + 1))


def test_edge_cases():
    n = 64
    pts = _ref_points(n, 5)
    host = ref_to_affine(REF_G1, pts)
    host[1] = host[0]  # repeated point
    host[2] = -host[0]  # P + (-P)
    host[3] = RefAffine.identity(REF_G1)  # identity points
    host[4] = RefAffine.identity(REF_G1)
    points = np.asarray(ref_from_affine(REF_G1, host))
    scalars = _scalars(n, 6)
    scalars[1] = scalars[2] = scalars[0]  # P, P, -P into the same buckets
    scalars[10:20] = [0] * 10
    scalars[20:30] = [scalars[30]] * 10
    scalars[40] = 1
    scalars[41] = P - 1
    _check(points, scalars)


def test_all_zero_scalars_and_all_identity_points():
    pts = _ref_points(16, 7)
    _check(pts, [0] * 16)
    ident = np.asarray(ref_from_affine(REF_G1, [RefAffine.identity(REF_G1)] * 16))
    _check(ident, _scalars(16, 8))


def test_fixed_base():
    s = _scalars(40, 9) + [0, 1, P - 1]
    want = ref_to_affine(REF_G1, ref_msm.fixed_base_msm(REF_G1, RefAffine.generator(REF_G1), s))
    got = msm.fixed_base_msm(
        BN254_G1, AffinePoint.generator(BN254_G1), limb.from_canonical_ints(BN254_G1.scalar, s)
    )
    assert all(_same(a, b) for a, b in zip(cdev.affine_to_host(BN254_G1, got), want))
    assert got.shape == (len(s), 2, 8)
    # and the basis carries back to the reference's projective form
    back = convert.basis_to_reference(got)
    assert [(int(p.x), int(p.y)) for p in ref_to_affine(REF_G1, back)[1:]] == \
        [(int(p.x), int(p.y)) for p in want[1:]]
    assert ref_limb.IS_CPP
