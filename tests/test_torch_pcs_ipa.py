"""Multilinear IPA on Grumpkin on the CPU against the JAX package on its cpp
backend: the setup's basis point for point, the frozen HyperPlonk proof
tests/golden/hyperplonk_ipa_k5.bin byte for byte, commit/open/verify with
equal proof bytes, and the harness's ``--system pcs --pcs ipa``; see
test_torch_pcs_gemini for the checks."""

import pytest
import torch

from test_torch_pcs_gemini import check_golden, check_harness, check_round_trip


def test_basis_equals_reference():
    """The batched hash-to-curve of the setup gives the reference's points.
    At these sizes every index finds its point within the batch's first
    tries; test_hash_to_curve_batch_retries covers the retries."""
    from plonkish_tpu.curves.device import to_affine_host
    from plonkish_tpu.pcs.ipa import MultilinearIpa as RefIpa
    from plonkish_tpu_torch.curves import device as cdev
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1
    from plonkish_tpu_torch.pcs import ipa

    n = 64
    ref = RefIpa().setup(n, 0)
    want = [(int(p.x), int(p.y)) for p in to_affine_host(ref.curve, ref.g)]
    got = ipa.MultilinearIpa(device="cpu").setup(n, 0)
    assert [(int(p.x), int(p.y)) for p in cdev.affine_to_host(GRUMPKIN_G1, got.g)] == want
    assert (int(got.h.x), int(got.h.y)) == (int(ref.h.x), int(ref.h.y))
    # one index at a time, with a counter of retries of its own
    tail = ipa.hash_to_curve_batch(GRUMPKIN_G1, ipa.SETUP_TAG, 3, torch.device("cpu"))
    assert cdev.affine_to_host(GRUMPKIN_G1, tail) == [
        ipa.hash_to_curve(GRUMPKIN_G1, ipa.SETUP_TAG, i) for i in range(3)]


@pytest.mark.parametrize("tries", [1, 2])
def test_hash_to_curve_batch_retries(tries):
    """With one or two counters a batch, 128 or 67 of the 256 indices find
    no point in the first batch and take the retry branch: the points still
    equal the reference's hash_to_curve index by index."""
    from plonkish_tpu.curves.specs import GRUMPKIN_G1 as REF_GRUMPKIN
    from plonkish_tpu.pcs.ipa import hash_to_curve as ref_hash_to_curve
    from plonkish_tpu_torch.curves import device as cdev
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1
    from plonkish_tpu_torch.pcs import ipa

    n = 256
    got = ipa.hash_to_curve_batch(GRUMPKIN_G1, ipa.SETUP_TAG, n, torch.device("cpu"), tries=tries)
    want = [ref_hash_to_curve(REF_GRUMPKIN, ipa.SETUP_TAG, i) for i in range(n)]
    assert [(int(p.x), int(p.y)) for p in cdev.affine_to_host(GRUMPKIN_G1, got)] == [
        (int(p.x), int(p.y)) for p in want]


def test_golden_ipa_k5():
    check_golden("ipa", 5)


@pytest.mark.parametrize("k", [4, 5, 6])
def test_commit_open_equals_reference(k):
    check_round_trip("ipa", k)


def test_harness_pcs_ipa(tmp_path, monkeypatch):
    check_harness("ipa", tmp_path, monkeypatch)
