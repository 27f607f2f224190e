"""HyperPlonk over BN254 with multilinear KZG, proved by the port on the CPU
(every kernel through its plain version): the proof equals the frozen
fixture tests/golden/hyperplonk_kzg_k3.bin byte for byte, both verifiers
accept it, and tampered proofs and instances are rejected.

The helpers here serve the k5 and lookup-k5 files too."""

import pathlib
import random

import pytest
import torch

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"


def prove_with_port(k, circuit_name):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.models import circuits
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    ci, circuit = getattr(circuits, circuit_name)(BN254_FR, k, random.Random(1), random.Random(2))
    backend = HyperPlonk(MultilinearKzg(device="cpu"))
    param = backend.setup(ci, random.Random(0))
    pp, vp = backend.preprocess(param, ci)
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, circuit, tr)
    return backend, vp, circuit, tr.into_proof()


def reference_verify(k, circuit_name, proof):
    from plonkish_tpu.backend.hyperplonk import HyperPlonk
    from plonkish_tpu.fields import BN254_FR
    from plonkish_tpu.models import circuits
    from plonkish_tpu.pcs.kzg import MultilinearKzg
    from plonkish_tpu.utils.transcript import Keccak256Transcript

    ci, circuit = getattr(circuits, circuit_name)(BN254_FR, k, random.Random(1), random.Random(2))
    backend = HyperPlonk(MultilinearKzg())
    param = backend.setup(ci, random.Random(0))
    _, vp = backend.preprocess(param, ci)
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, proof))


def check_golden(k, circuit_name, fixture):
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    backend, vp, circuit, proof = prove_with_port(k, circuit_name)
    assert proof == (GOLDEN / fixture).read_bytes()

    def verify(data, instances=None):
        backend.verify(vp, instances or circuit.instances(),
                       Keccak256Transcript.from_proof(BN254_FR, data))

    verify(proof)
    reference_verify(k, circuit_name, proof)
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 0x01
    with pytest.raises((ValueError, EOFError)):
        verify(bytes(bad))
    with pytest.raises((ValueError, EOFError)):
        verify(proof[:-32])
    wrong = [[v + 1 for v in col] for col in circuit.instances()]
    with pytest.raises((ValueError, EOFError)):
        verify(proof, wrong)


def test_golden_kzg_k3():
    check_golden(3, "rand_vanilla_plonk_circuit", "hyperplonk_kzg_k3.bin")
