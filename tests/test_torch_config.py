"""The port's flags (plonkish_tpu_torch/config.py) against the JAX package's,
and the sanity checks they gate (the reference's `sanity-check` feature)."""

import random

import pytest

from plonkish_tpu import config as jconfig
from plonkish_tpu_torch import config

FLAGS = {
    "PLONKISH_TPU_TIMER": "timer_enabled",
    "PLONKISH_TPU_SANITY": "sanity_checks",
    "PLONKISH_TPU_DEVICE_FS": "device_fs",
    "PLONKISH_TPU_FUSED_ROUNDS": "fused_rounds",
}


@pytest.mark.parametrize("env", sorted(FLAGS))
@pytest.mark.parametrize("value", [None, "0", "1", "true", ""])
def test_flags_read_the_environment_as_the_reference(env, value, monkeypatch):
    """Each flag is read at each call, under the same name, default and
    spelling as the JAX package's."""
    if value is None:
        monkeypatch.delenv(env, raising=False)
    else:
        monkeypatch.setenv(env, value)
    name = FLAGS[env]
    assert getattr(config, name)() == getattr(jconfig, name)()


def _broken_copy(circuit_info, circuit, mock_cls, fp):
    """The circuit with one witness cell of a copy cycle changed: the copy
    constraint (and the gate) no longer hold."""
    cycle = next(c for c in circuit_info.permutations
                 if len(c) > 1 and any(poly >= 6 for poly, _ in c))
    poly, row = next((poly, row) for poly, row in cycle if poly >= 6)
    witness = [list(col) for col in circuit.synthesize(0, [])]
    witness[poly - 6][row] = witness[poly - 6][row] + fp
    return mock_cls(circuit.instances(), witness)


def _prove_port(circuit_fn, broken):
    from plonkish_tpu_torch.backend.circuit import MockCircuit
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.models import circuits
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    ci, circuit = getattr(circuits, circuit_fn)(BN254_FR, 4, random.Random(1), random.Random(2))
    if broken:
        circuit = _broken_copy(ci, circuit, MockCircuit, Fp.one(BN254_FR))
    backend = HyperPlonk(MultilinearKzg(device="cpu"))
    pp, vp = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, circuit, tr)
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, tr.into_proof()))


def _prove_reference_broken():
    from plonkish_tpu.backend.circuit import MockCircuit
    from plonkish_tpu.backend.hyperplonk import HyperPlonk
    from plonkish_tpu.fields import BN254_FR
    from plonkish_tpu.fields.host import Fp
    from plonkish_tpu.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu.pcs.kzg import MultilinearKzg
    from plonkish_tpu.utils.transcript import Keccak256Transcript

    ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, 4, random.Random(1), random.Random(2))
    circuit = _broken_copy(ci, circuit, MockCircuit, Fp.one(BN254_FR))
    backend = HyperPlonk(MultilinearKzg())
    pp, _ = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    backend.prove(pp, circuit, Keccak256Transcript(BN254_FR))


@pytest.mark.parametrize("circuit_fn", ["rand_vanilla_plonk_circuit",
                                        "rand_vanilla_plonk_with_lookup_circuit"])
def test_sanity_checks_pass_a_valid_prove(circuit_fn, monkeypatch):
    """Every sanity check on (the sum-check's rounds, the lookup h sum, the
    grand product, the KZG open's claims): a valid prove passes and verifies."""
    monkeypatch.setenv("PLONKISH_TPU_SANITY", "1")
    _prove_port(circuit_fn, broken=False)


def test_broken_copy_constraint_raises_as_the_reference(monkeypatch):
    monkeypatch.setenv("PLONKISH_TPU_SANITY", "1")
    with pytest.raises(AssertionError) as port:
        _prove_port("rand_vanilla_plonk_circuit", broken=True)
    with pytest.raises(AssertionError) as ref:
        _prove_reference_broken()
    assert str(port.value) == str(ref.value) == "sanity: permutation grand product != 1"


def test_without_the_flag_the_broken_witness_proves(monkeypatch):
    """The checks are gated: without the flag the prover does not look, and
    the verifier rejects the proof."""
    monkeypatch.delenv("PLONKISH_TPU_SANITY", raising=False)
    with pytest.raises(ValueError):
        _prove_port("rand_vanilla_plonk_circuit", broken=True)
