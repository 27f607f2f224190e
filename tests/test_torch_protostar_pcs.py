"""Protostar over the other PCS of tests/test_protostar.py::test_protostar_other_pcs
(IPA on Grumpkin, the circuit over BN254 Fq; Gemini and Zeromorph on BN254)
in the port on the CPU against the JAX package on its cpp backend, at
num_vars 4: equal accumulators after every fold, equal decider proofs, both
verifiers; see test_torch_protostar for the checks."""

import pytest

from test_torch_protostar import check_scheme


@pytest.mark.parametrize("pcs_name", ["ipa", "gemini", "zeromorph"])
def test_protostar_other_pcs(pcs_name):
    check_scheme("protostar", pcs_name, 4, "vanilla")
