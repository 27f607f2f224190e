"""The port's HyperPlonk KZG proof of the vanilla-PLONK circuit with a logUp
lookup at k = 5 on the CPU equals the frozen fixture
tests/golden/hyperplonk_kzg_lookup_k5.bin; see test_torch_hyperplonk_k3."""

from test_torch_hyperplonk_k3 import check_golden


def test_golden_kzg_lookup_k5():
    check_golden(5, "rand_vanilla_plonk_with_lookup_circuit", "hyperplonk_kzg_lookup_k5.bin")
