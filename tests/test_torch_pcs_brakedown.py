"""Multilinear Brakedown on the CPU against the JAX package on its cpp
backend: the frozen HyperPlonk proofs tests/golden/hyperplonk_brakedown_k3
and _k5 byte for byte, the code's matrices drawn in the reference's order
and its encoding, commit/open/verify with equal roots and proof bytes, and
the harness's ``--system pcs --pcs brakedown`` (the default spec); see
test_torch_pcs_gemini for the checks."""

import dataclasses
import random

import pytest

from test_torch_pcs_gemini import check_golden, check_harness, check_round_trip


@pytest.mark.parametrize("k", [3, 5])
def test_golden_brakedown(k):
    check_golden("brakedown", k)


@pytest.mark.parametrize("k", [4, 5, 6])
def test_commit_open_equals_reference(k):
    check_round_trip("brakedown", k)


def test_code_equals_reference():
    """Sparse matrices from the same rng (rows, sorted columns, then
    coefficients) and the same codeword for a batch of rows."""
    import numpy as np
    from plonkish_tpu.fields import BN254_FR as REF_FR
    from plonkish_tpu.fields import limb as ref_limb
    from plonkish_tpu.pcs import brakedown_code as ref_code
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.pcs import brakedown_code

    num_vars, n_0 = 10, 20
    ref = ref_code.Brakedown.new_multilinear(
        REF_FR, ref_code.BRAKEDOWN_SPEC_6, num_vars, n_0, random.Random(3))
    code = brakedown_code.Brakedown.new_multilinear(
        BN254_FR, brakedown_code.BRAKEDOWN_SPEC_6, num_vars, n_0, random.Random(3))
    assert (code.row_len, code.codeword_len) == (ref.row_len, ref.codeword_len)
    for mine, theirs in zip(code.a + code.b, ref.a + ref.b):
        assert dataclasses.astuple(mine.dimension) == dataclasses.astuple(theirs.dimension)
        assert mine.rows.tolist() == np.asarray(theirs.rows).tolist()
        assert mine.cols.tolist() == np.asarray(theirs.cols).tolist()
    rng = random.Random(4)
    values = [rng.randrange(BN254_FR.p) for _ in range(2 * code.row_len)]
    got = code.encode(limb.from_canonical_ints(BN254_FR, values).reshape(2, code.row_len, 8))
    want = ref.encode(ref_limb.to_mont(REF_FR, ref_limb.from_ints(values)).reshape(
        2, ref.row_len, ref_limb.L))
    canon = ref_limb.from_mont(REF_FR, want).reshape(-1, ref_limb.L)
    assert limb.to_canonical_ints(BN254_FR, got) == [int(v) for v in ref_limb.to_ints(canon)]


def test_harness_pcs_brakedown(tmp_path, monkeypatch):
    check_harness("brakedown", tmp_path, monkeypatch)
