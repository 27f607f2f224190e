"""The port's univariate (halo2-style) PLONK (plonkish_tpu_torch/backend/
univariate.py) against the reference's on its cpp backend, on the circuits
and seeds of tests/test_univariate_plonk.py: proof bytes equal at k = 3, 5
and 7, each package's verifier accepting the other's proof, the port proving
with the reference's preprocessed params, and tampering rejected.  Each
reference and port run is made once per module."""

import functools
import random

import pytest
import torch

from plonkish_tpu.backend.univariate import UnivariatePlonk as RefUnivariatePlonk
from plonkish_tpu.fields import BN254_FR as REF_FR
from plonkish_tpu.fields.host import Fp as RefFp
from plonkish_tpu.models.circuits import rand_vanilla_plonk_circuit as ref_circuit
from plonkish_tpu.utils.transcript import Keccak256Transcript as RefTranscript
from plonkish_tpu_torch import convert
from plonkish_tpu_torch.backend.univariate import UnivariatePlonk, instance_rows
from plonkish_tpu_torch.backend.hyperplonk.prover import row_mapping
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FR
from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
from plonkish_tpu_torch.pcs.univariate_kzg import UnivariateKzg
from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

torch.set_num_threads(1)


def _seeds(k):
    """tests/test_univariate_plonk.py: run(num_vars, seed=num_vars)."""
    return random.Random(42 + k), random.Random(4242 + k)


@functools.lru_cache(maxsize=None)
def reference(k):
    info, circuit = ref_circuit(REF_FR, k, *_seeds(k))
    backend = RefUnivariatePlonk()
    pp, vp = backend.preprocess(backend.setup(info, random.Random(0)), info)
    tr = RefTranscript(REF_FR)
    backend.prove(pp, circuit, tr)
    return backend, pp, vp, circuit, tr.into_proof()


@functools.lru_cache(maxsize=None)
def port(k):
    info, circuit = rand_vanilla_plonk_circuit(BN254_FR, k, *_seeds(k))
    backend = UnivariatePlonk(UnivariateKzg(device="cpu"))
    pp, vp = backend.preprocess(backend.setup(info, random.Random(0)), info)
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, circuit, tr)
    return backend, pp, vp, circuit, tr.into_proof()


@pytest.mark.parametrize("k", [3, 5, 7])
def test_proof_bytes_equal_reference(k):
    assert port(k)[4] == reference(k)[4]


@pytest.mark.parametrize("k", [3, 5])
def test_each_verifier_accepts_the_others_proof(k):
    backend, _, vp, circuit, proof = port(k)
    ref_backend, _, ref_vp, ref_circuit_, ref_proof = reference(k)
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, ref_proof))
    ref_backend.verify(ref_vp, ref_circuit_.instances(), RefTranscript.from_proof(REF_FR, proof))


def test_preprocess_equals_reference():
    """Selector and σ coefficients, σ's values on H and the eight
    commitments of the port's preprocess equal the reference's."""
    _, pp, vp, _, _ = port(5)
    _, ref_pp, _, _, _ = reference(5)
    for ours, theirs in ((pp.fixed_coeffs, ref_pp.fixed_coeffs),
                         (pp.sigma_coeffs, ref_pp.sigma_coeffs),
                         (pp.sigma_evals, ref_pp.sigma_evals)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert (convert.limbs_to_digits(a) == b).all()
    for ours, theirs in ((vp.fixed_comms, ref_pp.fixed_comms), (vp.sigma_comms, ref_pp.sigma_comms)):
        assert [(int(p.x), int(p.y)) for p in ours] == [(int(p.x), int(p.y)) for p in theirs]


def test_proves_with_reference_params():
    """The reference's preprocessed params carried across by
    convert.univariate_plonk_params_from_reference give the same proof."""
    _, ref_pp, ref_vp, _, want = reference(5)
    pp, vp = convert.univariate_plonk_params_from_reference(ref_pp, ref_vp, "cpu")
    backend, _, _, circuit, _ = port(5)
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, circuit, tr)
    assert tr.into_proof() == want
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, want))


def test_rejects_tampered_instance():
    backend, _, vp, circuit, proof = port(3)
    bad = [list(circuit.instances()[0])]
    bad[0][0] = bad[0][0] + Fp(1, BN254_FR)
    with pytest.raises(ValueError):
        backend.verify(vp, bad, Keccak256Transcript.from_proof(BN254_FR, proof))
    ref_backend, _, ref_vp, ref_circuit_, _ = reference(3)
    ref_bad = [list(ref_circuit_.instances()[0])]
    ref_bad[0][0] = ref_bad[0][0] + RefFp(1, REF_FR)
    with pytest.raises(Exception):
        ref_backend.verify(ref_vp, ref_bad, RefTranscript.from_proof(REF_FR, proof))


@pytest.mark.parametrize("where", [3, 2])
def test_rejects_flipped_byte(where):
    backend, _, vp, circuit, proof = port(3)
    bad = bytearray(proof)
    bad[len(bad) // where] ^= 1
    with pytest.raises((ValueError, EOFError)):
        backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, bytes(bad)))


@pytest.mark.parametrize("k", [3, 6, 10])
def test_instance_rows_are_the_row_mapping(k):
    n = 1 << k
    for m in (0, 1, k, n - 1, n):
        assert instance_rows(k, m) == row_mapping(k)[:m]


def test_backend_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the failure without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        UnivariatePlonk()
