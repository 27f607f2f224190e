"""The port's aggregation circuit (plonkish_tpu_torch/models/aggregation.py,
an in-circuit Grumpkin double-and-add ladder) against the reference's, in
the shapes of tests/test_aggregation.py: the circuits at k = 5 and 6 equal
(info and witness); the HyperPlonk proofs equal byte for byte over
Brakedown (BRAKEDOWN_SPEC_TEST, k = 6) and over multilinear KZG (k = 5); a
tampered witness rejected; and a Protostar fold at k = 5 equal to the
reference's fold by fold, then the same decider proof."""

import importlib
import random

import pytest
import torch

from test_torch_frontend import assert_same_info, assert_same_witness

torch.set_num_threads(1)

PORT, REF = "plonkish_tpu_torch", "plonkish_tpu"


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _circuit(pkg, k, seeds):
    spec = _mod(pkg, "fields.spec").BN254_FR
    return _mod(pkg, "models.aggregation").rand_aggregation_circuit(
        spec, k, random.Random(seeds[0]), random.Random(seeds[1]))


def _pcs(pkg, name):
    kw = {"device": "cpu"} if pkg == PORT else {}
    if name == "kzg":
        return _mod(pkg, "pcs.kzg").MultilinearKzg(**kw)
    spec = _mod(pkg, "fields.spec").BN254_FR
    test_spec = _mod(pkg, "pcs.brakedown_code").BRAKEDOWN_SPEC_TEST
    return _mod(pkg, "pcs.brakedown").MultilinearBrakedown(spec, test_spec, **kw)


def _prove(pkg, pcs_name, k, seeds, tamper=False):
    info, circuit = _circuit(pkg, k, seeds)
    if tamper:  # one ladder output off by one: the chained EC constraint fails
        circuit._witnesses[2][3] = circuit._witnesses[2][3] + _mod(pkg, "fields.host").Fp.one(
            info.field_spec)
    backend = _mod(pkg, "backend.hyperplonk").HyperPlonk(_pcs(pkg, pcs_name))
    pp, vp = backend.preprocess(backend.setup(info, random.Random(0)), info)
    Transcript = _mod(pkg, "utils.transcript").Keccak256Transcript
    tr = Transcript(info.field_spec)
    backend.prove(pp, circuit, tr)
    proof = tr.into_proof()
    return lambda p=proof: backend.verify(
        vp, circuit.instances(), Transcript.from_proof(info.field_spec, p)), proof


@pytest.mark.parametrize("k,seeds", [(5, (3, 4)), (6, (1, 2))])
def test_circuit_and_witness_equal_reference(k, seeds):
    info, circuit = _circuit(PORT, k, seeds)
    ref_info, ref_circuit = _circuit(REF, k, seeds)
    assert_same_info(info, ref_info)
    assert_same_witness(circuit, ref_circuit)
    assert info.num_poly() == 10 and not info.lookups


@pytest.mark.parametrize("pcs_name,k,seeds", [("brakedown", 6, (1, 2)), ("kzg", 5, (1, 2))])
def test_hyperplonk_proof_equals_reference(pcs_name, k, seeds):
    verify, proof = _prove(PORT, pcs_name, k, seeds)
    assert proof == _prove(REF, pcs_name, k, seeds)[1]
    verify()
    bad = bytearray(proof)
    bad[len(bad) // 3] ^= 1
    with pytest.raises((ValueError, EOFError)):
        verify(bytes(bad))


def test_rejects_tampered_witness():
    verify, _ = _prove(PORT, "brakedown", 5, (3, 4), tamper=True)
    with pytest.raises(ValueError):
        verify()


def test_protostar_fold_equals_reference():
    """tests/test_aggregation.py::test_aggregation_protostar_fold in both
    packages: two folds at k = 5 (accumulators and fold transcripts equal
    after each), then prove_decider, equal proofs, each verifier accepting."""
    from test_torch_protostar import assert_same_accumulator

    sides = []
    for pkg in (PORT, REF):
        info, _ = _circuit(pkg, 5, (5, 6))
        scheme = _mod(pkg, "accumulation.protostar").Protostar(_pcs(pkg, "kzg"))
        pp, vp = scheme.preprocess(scheme.setup(info, random.Random(0)), info)
        sides.append((pkg, scheme, pp, vp, scheme.init_accumulator(pp), info.field_spec,
                      _mod(pkg, "utils.transcript").Keccak256Transcript))
    for i in range(2):
        proofs = []
        for pkg, scheme, pp, _, acc, spec, Transcript in sides:
            tr = Transcript(spec)
            scheme.prove_accumulation_from_nark(pp, acc, _circuit(pkg, 5, (5, 100 + i))[1], tr)
            proofs.append(tr.into_proof())
        assert proofs[0] == proofs[1], f"fold {i}"
        assert_same_accumulator(sides[0][4], sides[1][4], f"after fold {i}")
    proofs = []
    for _, scheme, pp, _, acc, spec, Transcript in sides:
        tr = Transcript(spec)
        scheme.prove_decider(pp, acc, tr)
        proofs.append(tr.into_proof())
    assert proofs[0] == proofs[1]
    for _, scheme, _, vp, acc, spec, Transcript in sides:
        scheme.verify_decider(vp, acc.instance, Transcript.from_proof(spec, proofs[0]))
