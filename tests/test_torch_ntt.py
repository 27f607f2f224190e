"""The port's NTT (plonkish_tpu_torch/poly/ntt.py) against the reference's
(plonkish_tpu/poly/ntt.py) on its cpp backend: the forward and inverse
transforms, the coset scaling and the twiddle tables, element for element,
over BN254 Fr and BLS12-381 Fr; and the naive-DFT and coset checks of
tests/test_ntt.py.  Exact equality."""

import random

import numpy as np
import pytest
import torch

from plonkish_tpu.fields import BLS12_381_FR as REF_BLS, BN254_FR as REF_FR
from plonkish_tpu.fields import limb as ref_limb
from plonkish_tpu.poly import ntt as ref_ntt
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.spec import BLS12_381_FR, BN254_FR
from plonkish_tpu_torch.poly import ntt

torch.set_num_threads(1)

SPECS = {"bn254_fr": (BN254_FR, REF_FR), "bls12_381_fr": (BLS12_381_FR, REF_BLS)}


def _values(spec, n, seed):
    rng = random.Random(seed)
    return [rng.randrange(spec.p) for _ in range(n)]


def _both(field, n, seed):
    spec, ref_spec = SPECS[field]
    vals = _values(spec, n, seed)
    return vals, limb.from_canonical_ints(spec, vals), ref_limb.to_mont(ref_spec, ref_limb.from_ints(vals))


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("log_n", range(1, 11))
def test_ntt_equals_reference(field, log_n):
    """Forward, inverse, and the coset scaling both ways, digit for digit."""
    spec, ref_spec = SPECS[field]
    _, x, rx = _both(field, 1 << log_n, log_n)
    for inverse in (False, True):
        want = np.asarray(ref_ntt.ntt(ref_spec, rx, inverse=inverse))
        assert np.array_equal(convert.limbs_to_digits(ntt.ntt(spec, x, inverse=inverse)), want)
        want = np.asarray(ref_ntt.coset_scale(ref_spec, rx, 19, invert=inverse))
        assert np.array_equal(
            convert.limbs_to_digits(ntt.coset_scale(spec, x, 19, invert=inverse)), want)


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_tables_equal_reference_plan(field, inverse):
    """Each stage's twiddles, built on the device by doubling, are the
    reference's `_plan` table of that stage (which repeats each twiddle over
    the stage's sub-transform columns), and n^-1 is its n_inv."""
    spec, ref_spec = SPECS[field]
    for log_n in range(1, 11):
        stages, n_inv = ref_ntt._plan(ref_spec, log_n, inverse)
        n = 1 << log_n
        for t, table in enumerate(stages):
            rows = table.reshape(n >> (t + 1), 1 << t, 16)
            assert (rows == rows[:, :1]).all()
            got = ntt.stage_twiddles(spec, log_n, inverse, t, "cpu")
            assert np.array_equal(convert.limbs_to_digits(got), rows[:, 0]), (log_n, t)
        _, ours = ntt.plan(spec, log_n, inverse, "cpu")
        assert np.array_equal(ours[:, 0].numpy().astype(np.uint32), np.asarray(n_inv))
    assert ntt.root_of_unity(spec, 10) == ref_ntt.root_of_unity(ref_spec, 10)


@pytest.mark.parametrize("field", sorted(SPECS))
@pytest.mark.parametrize("log_n", [1, 3, 5])
def test_ntt_matches_naive_dft(field, log_n):
    spec, _ = SPECS[field]
    n = 1 << log_n
    vals, x, _ = _both(field, n, log_n)
    w = ntt.root_of_unity(spec, log_n)
    out = limb.to_canonical_ints(spec, ntt.ntt(spec, x))
    for k in range(n):
        want = sum(v * pow(w, j * k, spec.p) for j, v in enumerate(vals)) % spec.p
        assert out[k] == want, f"k={k}"


def test_ntt_inverse_round_trip():
    n = 1 << 6
    vals, x, _ = _both("bn254_fr", n, 9)
    back = ntt.ntt(BN254_FR, ntt.ntt(BN254_FR, x), inverse=True)
    assert limb.to_canonical_ints(BN254_FR, back) == vals


def test_coset_ntt_evaluates_on_coset():
    spec = BN254_FR
    log_n, shift = 4, 5
    n = 1 << log_n
    coeffs, x, _ = _both("bn254_fr", n, 3)
    w = ntt.root_of_unity(spec, log_n)
    out = limb.to_canonical_ints(spec, ntt.ntt(spec, ntt.coset_scale(spec, x, shift)))
    for k in range(n):
        pt = (shift * pow(w, k, spec.p)) % spec.p
        want = sum(c * pow(pt, j, spec.p) for j, c in enumerate(coeffs)) % spec.p
        assert out[k] == want, f"k={k}"
