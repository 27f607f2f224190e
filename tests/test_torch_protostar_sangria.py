"""Sangria (Protostar without compression) in the port on the CPU against
the JAX package on its cpp backend, at num_vars 4 as tests/test_protostar.py
runs it: equal accumulators after every fold, equal decider proofs, both
verifiers; see test_torch_protostar for the checks."""

import pytest

from test_torch_protostar import check_scheme


@pytest.mark.parametrize("circuit", ["vanilla", "lookup"])
def test_sangria(circuit):
    check_scheme("sangria", "kzg", 4, circuit)
