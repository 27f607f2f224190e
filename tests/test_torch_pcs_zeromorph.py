"""Zeromorph on the CPU against the JAX package on its cpp backend; see
test_torch_pcs_gemini for the checks."""

import pytest

from test_torch_pcs_gemini import check_golden, check_harness, check_round_trip


def test_golden_zeromorph_k5():
    check_golden("zeromorph", 5)


@pytest.mark.parametrize("k", [4, 5, 6])
def test_commit_open_equals_reference(k):
    check_round_trip("zeromorph", k)


def test_harness_pcs_zeromorph(tmp_path, monkeypatch):
    check_harness("zeromorph", tmp_path, monkeypatch)
