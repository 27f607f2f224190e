"""The frozen proofs of tests/golden with every sum-check on the device
transcript (the rule patched as in tests/test_torch_device_fs.py), with
PLONKISH_TPU_FUSED_ROUNDS at 0 (K3 -> K6 -> K4 a round) and at 1 (each
Evaluations sum-check through K7, kernels/sumcheck.py fused_rounds), on the
CPU where every kernel runs its plain version: byte for byte."""

import pathlib
import random

import pytest
import torch

from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.piop import sum_check as sc
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"
HYPERPLONK = {
    "hyperplonk_kzg_k3": ("kzg", "rand_vanilla_plonk_circuit"),
    "hyperplonk_kzg_k5": ("kzg", "rand_vanilla_plonk_circuit"),
    "hyperplonk_kzg_lookup_k5": ("kzg", "rand_vanilla_plonk_with_lookup_circuit"),
    "hyperplonk_gemini_k5": ("gemini", "rand_vanilla_plonk_circuit"),
    "hyperplonk_zeromorph_k5": ("zeromorph", "rand_vanilla_plonk_circuit"),
    "hyperplonk_ipa_k5": ("ipa", "rand_vanilla_plonk_circuit"),
    "hyperplonk_hyrax_k5": ("hyrax", "rand_vanilla_plonk_circuit"),
    "hyperplonk_brakedown_k3": ("brakedown", "rand_vanilla_plonk_circuit"),
    "hyperplonk_brakedown_k5": ("brakedown", "rand_vanilla_plonk_circuit"),
}


@pytest.fixture(params=["0", "1"], ids=["per_round", "fused"])
def flag(request, monkeypatch):
    monkeypatch.setattr(sc, "device_fs_selected",
                        lambda state, prover: sc.device_fs_eligible(prover))
    monkeypatch.setenv("PLONKISH_TPU_FUSED_ROUNDS", request.param)
    return request.param


def _pcs(name):
    from plonkish_tpu_torch.pcs.brakedown import MultilinearBrakedown
    from plonkish_tpu_torch.pcs.brakedown_code import BRAKEDOWN_SPEC_TEST
    from plonkish_tpu_torch.pcs.gemini import Gemini
    from plonkish_tpu_torch.pcs.hyrax import MultilinearHyrax
    from plonkish_tpu_torch.pcs.ipa import MultilinearIpa
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.pcs.zeromorph import Zeromorph

    if name == "brakedown":
        return MultilinearBrakedown(BN254_FR, BRAKEDOWN_SPEC_TEST, device="cpu")
    return {"kzg": MultilinearKzg, "gemini": Gemini, "zeromorph": Zeromorph,
            "ipa": MultilinearIpa, "hyrax": MultilinearHyrax}[name](device="cpu")


@pytest.mark.parametrize("name", sorted(HYPERPLONK))
def test_hyperplonk_golden(name, flag):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk

    pcs_name, circuit_fn = HYPERPLONK[name]
    pcs = _pcs(pcs_name)
    spec = pcs.field_spec
    ci, circuit = getattr(circuits, circuit_fn)(spec, int(name[-1]), random.Random(1),
                                                random.Random(2))
    backend = HyperPlonk(pcs)
    pp, _ = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    tr = Keccak256Transcript(spec)
    backend.prove(pp, circuit, tr)
    assert tr.into_proof() == (GOLDEN / f"{name}.bin").read_bytes()


def test_protostar_decider_golden(flag):
    """Two folds and the decider with the last NARK (KZG, k = 3)."""
    from plonkish_tpu_torch.accumulation.protostar import Protostar
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg

    made = [circuits.rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(42),
                                                random.Random(seed))
            for seed in (0, 100, 101, 102)]
    scheme = Protostar(MultilinearKzg(device="cpu"))
    pp, _ = scheme.preprocess(scheme.setup(made[0][0], random.Random(0)), made[0][0])
    acc = scheme.init_accumulator(pp)
    for _, circuit in made[1:3]:
        scheme.prove_accumulation_from_nark(pp, acc, circuit, Keccak256Transcript(BN254_FR))
    tr = Keccak256Transcript(BN254_FR)
    scheme.prove_decider_with_last_nark(pp, acc, made[3][1], tr)
    assert tr.into_proof() == (GOLDEN / "protostar_kzg_decider_k3.bin").read_bytes()
