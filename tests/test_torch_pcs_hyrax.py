"""Multilinear Hyrax on Grumpkin on the CPU against the JAX package on its
cpp backend; see test_torch_pcs_gemini for the checks."""

import pytest

from test_torch_pcs_gemini import check_golden, check_harness, check_round_trip


def test_golden_hyrax_k5():
    check_golden("hyrax", 5)


@pytest.mark.parametrize("k", [4, 5, 6])
def test_commit_open_equals_reference(k):
    check_round_trip("hyrax", k)


def test_combine_skips_dummy_commitments():
    """Empty commitments (the instances' dummies) take no part in the
    verifier's combination of the chunks."""
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.pcs.hyrax import MultilinearHyrax

    pcs = MultilinearHyrax(device="cpu")
    g = AffinePoint.generator(GRUMPKIN_G1)
    spec = pcs.field_spec
    comms = [[g, g.double()], [], [g.double(), g]]
    got = pcs.combine_commitments(None, [Fp(3, spec), Fp(5, spec), Fp(7, spec)], comms)
    assert got == [g.scalar_mul(3 + 14), g.scalar_mul(6 + 7)]
    assert pcs.dummy_commitment() == []


def test_harness_pcs_hyrax(tmp_path, monkeypatch):
    check_harness("hyrax", tmp_path, monkeypatch)
