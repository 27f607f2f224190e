"""The port's torch field layer against the reference limb ops (cpp backend),
for BN254 Fr and Fq: random values from a numpy seed plus the edge values
0, 1 and p - 1.  Exact equality of every element."""

import numpy as np
import pytest
import torch

from plonkish_tpu.fields import limb as ref_limb
from plonkish_tpu.fields.spec import BN254_FQ as REF_FQ, BN254_FR as REF_FR
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

SPECS = {"fr": (BN254_FR, REF_FR), "fq": (BN254_FQ, REF_FQ)}


def _values(p, n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    return [0, 1, p - 1, p - 2] + vals


def _both(spec, ref_spec, vals):
    """Montgomery values as (port tensor, reference digits)."""
    ref = ref_limb.to_mont(ref_spec, ref_limb.from_ints(vals))
    return convert.digits_to_limbs(ref), ref


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_binary_ops(field):
    spec, ref_spec = SPECS[field]
    a, ra = _both(spec, ref_spec, _values(spec.p, 96, 1))
    b, rb = _both(spec, ref_spec, _values(spec.p, 96, 2)[::-1])
    for ours, theirs in (
        (limb.add, ref_limb.add), (limb.sub, ref_limb.sub), (limb.mont_mul, ref_limb.mont_mul),
    ):
        assert torch.equal(ours(spec, a, b), convert.digits_to_limbs(theirs(ref_spec, ra, rb)))
    assert torch.equal(limb.neg(spec, a), convert.digits_to_limbs(ref_limb.neg(ref_spec, ra)))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_conversions_and_inverses(field):
    spec, ref_spec = SPECS[field]
    vals = _values(spec.p, 64, 3)
    raw = limb.from_ints(vals)
    ref_raw = ref_limb.from_ints(vals)
    mont = limb.to_mont(spec, raw)
    assert torch.equal(mont, convert.digits_to_limbs(ref_limb.to_mont(ref_spec, ref_raw)))
    assert torch.equal(limb.from_mont(spec, mont), raw)
    ref_mont = ref_limb.to_mont(ref_spec, ref_raw)
    assert torch.equal(limb.batch_inv(spec, mont),
                       convert.digits_to_limbs(ref_limb.batch_inv(ref_spec, ref_mont)))
    assert torch.equal(limb.pow_const(spec, mont[:8], spec.p - 2),
                       convert.digits_to_limbs(ref_limb.inv(ref_spec, ref_mont[:8])))
    for i in (0, 1, 5):
        assert torch.equal(limb.inv_scalar(spec, mont[i]),
                           convert.digits_to_limbs(ref_limb.inv(ref_spec, ref_mont[i:i + 1]))[0])
    assert torch.equal(limb.prefix_mul(spec, mont[1:]),
                       convert.digits_to_limbs(ref_limb.prefix_mul(ref_spec, ref_mont[1:])))
    assert torch.equal(limb.sum_reduce(spec, mont),
                       convert.digits_to_limbs(ref_limb.sum_reduce(ref_spec, ref_mont)))


def test_fold_halves_matches_reference():
    spec, ref_spec = SPECS["fr"]
    lo, rlo = _both(spec, ref_spec, _values(spec.p, 32, 4))
    hi, rhi = _both(spec, ref_spec, _values(spec.p, 32, 5))
    x, rx = _both(spec, ref_spec, [123456789])
    got = limb.fold_halves(spec, lo, hi, x[0])
    want = ref_limb.fold_halves(ref_spec, rlo, rhi, rx[0])
    assert torch.equal(got, convert.digits_to_limbs(want))


def test_repacking_round_trip():
    rng = np.random.default_rng(6)
    digits = rng.integers(0, 1 << 16, size=(5, 3, 16), dtype=np.uint32)
    limbs = convert.digits_to_limbs(digits)
    assert limbs.dtype == torch.int32 and limbs.shape == (5, 3, 8)
    assert np.array_equal(convert.limbs_to_digits(limbs), digits)
    assert limb.to_ints(limbs[0, 0])[0] == sum(int(d) << (16 * i) for i, d in enumerate(digits[0, 0]))
