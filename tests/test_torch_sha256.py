"""The port's SHA-256 circuit (plonkish_tpu_torch/models/sha256.py) against
the reference's: the digest, the circuit info and the witness for one and
two blocks; the one-block HyperPlonk proof over multilinear KZG byte for
byte (the reference's seeds of tests/test_sha256.py), a wrong digest
rejected; the two-block prove and the Protostar fold of three compressions
gated as the reference gates them (PLONKISH_TPU_SLOW=1).  The one-block
proofs of both packages are made once per module."""

import functools
import hashlib
import os
import random

import pytest
import torch

from test_torch_frontend import assert_same_info, assert_same_witness

torch.set_num_threads(1)

SLOW = os.environ.get("PLONKISH_TPU_SLOW") == "1"


def _prove(pkg, msg, seed=7):
    """(backend, vp, circuit, proof) of sha256(msg) under HyperPlonk + KZG in
    package `pkg`, the SRS from `seed` (tests/test_sha256.py)."""
    import importlib

    sha = importlib.import_module(f"{pkg}.models.sha256")
    HyperPlonk = importlib.import_module(f"{pkg}.backend.hyperplonk").HyperPlonk
    MultilinearKzg = importlib.import_module(f"{pkg}.pcs.kzg").MultilinearKzg
    Transcript = importlib.import_module(f"{pkg}.utils.transcript").Keccak256Transcript
    info, circuit, digest = sha.sha256_circuit(msg)
    assert digest == hashlib.sha256(msg).digest()
    pcs = MultilinearKzg(device="cpu") if pkg == "plonkish_tpu_torch" else MultilinearKzg()
    backend = HyperPlonk(pcs)
    pp, vp = backend.preprocess(backend.setup(info, random.Random(seed)), info)
    tr = Transcript(info.field_spec)
    backend.prove(pp, circuit, tr)
    return backend, vp, circuit, tr.into_proof()


@functools.lru_cache(maxsize=None)
def one_block(pkg):
    return _prove(pkg, b"abc")


@pytest.mark.parametrize("blocks", [1, 2])
def test_circuit_and_witness_equal_reference(blocks):
    from plonkish_tpu.models import sha256 as ref_sha
    from plonkish_tpu_torch.models import sha256

    msg = b"abc" if blocks == 1 else sha256.message_for_blocks(2, seed=3)
    assert msg == (b"abc" if blocks == 1 else ref_sha.message_for_blocks(2, seed=3))
    info, circuit, digest = sha256.sha256_circuit(msg)
    ref_info, ref_circuit, ref_digest = ref_sha.sha256_circuit(msg)
    assert digest == ref_digest == hashlib.sha256(msg).digest()
    assert_same_info(info, ref_info)
    assert_same_witness(circuit, ref_circuit)
    assert sum(info.num_witness_polys) == 78 and info.num_poly() == 89


def test_circuit_shape_at_a_given_k():
    """The harness's sizing: (2^k - 10) // 140 blocks fill k rows; the
    smallest k that holds one block is 8."""
    from plonkish_tpu_torch import benchmark
    from plonkish_tpu_torch.fields.spec import BN254_FR

    info, circuit = benchmark.rand_sha256(BN254_FR, 8, None, None)
    assert info.k == 8 and len(circuit.instances()[0]) == 8
    with pytest.raises(AssertionError):
        benchmark.rand_sha256(BN254_FR, 7, None, None)


def test_one_block_proof_equals_reference():
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    backend, vp, circuit, proof = one_block("plonkish_tpu_torch")
    assert proof == one_block("plonkish_tpu")[3]
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, proof))


def test_rejects_wrong_digest():
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    backend, vp, circuit, proof = one_block("plonkish_tpu_torch")
    bad = [list(circuit.instances()[0])]
    bad[0][0] = bad[0][0] + Fp(1, BN254_FR)
    with pytest.raises(ValueError):
        backend.verify(vp, bad, Keccak256Transcript.from_proof(BN254_FR, proof))


@pytest.mark.skipif(not SLOW, reason="slow: full prove (set PLONKISH_TPU_SLOW=1)")
def test_two_blocks_chained_proof_equals_reference():
    from plonkish_tpu_torch.models.sha256 import message_for_blocks

    msg = message_for_blocks(2, seed=3)
    assert _prove("plonkish_tpu_torch", msg)[3] == _prove("plonkish_tpu", msg)[3]


@pytest.mark.skipif(not SLOW, reason="slow: sha256 IVC folding (set PLONKISH_TPU_SLOW=1)")
def test_protostar_folds_sha256_circuit():
    """tests/test_protostar.py::test_protostar_folds_sha256_circuit in both
    packages side by side: three SHA-256 compressions of the same structure
    at k = 8 folded, fold by fold equal, then the same decider proof."""
    import importlib

    from test_torch_protostar import assert_same_accumulator

    def side(pkg):
        sha = importlib.import_module(f"{pkg}.models.sha256")
        Protostar = importlib.import_module(f"{pkg}.accumulation.protostar").Protostar
        MultilinearKzg = importlib.import_module(f"{pkg}.pcs.kzg").MultilinearKzg
        Transcript = importlib.import_module(f"{pkg}.utils.transcript").Keccak256Transcript
        spec = importlib.import_module(f"{pkg}.fields.spec").BN254_FR
        make = lambda seed: sha.sha256_circuit(bytes([seed & 0xFF]) * 20, k=8, spec=spec)[:2]  # noqa: E731
        info, _ = make(0)
        circuits = [make(100 + i)[1] for i in range(3)]
        scheme = Protostar(MultilinearKzg(device="cpu") if pkg == "plonkish_tpu_torch"
                           else MultilinearKzg())
        pp, vp = scheme.preprocess(scheme.setup(info, random.Random(0)), info)
        return scheme, pp, vp, scheme.init_accumulator(pp), circuits, Transcript, spec

    port, ref = side("plonkish_tpu_torch"), side("plonkish_tpu")
    for i in range(2):
        proofs = []
        for scheme, pp, _, acc, circuits, Transcript, spec in (port, ref):
            tr = Transcript(spec)
            scheme.prove_accumulation_from_nark(pp, acc, circuits[i], tr)
            proofs.append(tr.into_proof())
        assert proofs[0] == proofs[1], f"fold {i}"
        assert_same_accumulator(port[3], ref[3], f"after fold {i}")
    out = []
    for scheme, pp, vp, acc, circuits, Transcript, spec in (port, ref):
        before = acc.instance.clone()
        tr = Transcript(spec)
        scheme.prove_decider_with_last_nark(pp, acc, circuits[2], tr)
        proof = tr.into_proof()
        scheme.verify_decider_with_last_nark(vp, before, circuits[2].instances(),
                                             Transcript.from_proof(spec, proof))
        out.append(proof)
    assert out[0] == out[1]
