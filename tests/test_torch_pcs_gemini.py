"""Gemini on the CPU against the JAX package on its cpp backend: the frozen
HyperPlonk proof tests/golden/hyperplonk_gemini_k5.bin byte for byte, a
commit/open/verify of one polynomial at k = 4..6 with equal commitments and
equal proof bytes, and the harness's ``--system pcs --pcs gemini``.

The helpers here serve the other test_torch_pcs_* files too."""

import importlib
import pathlib
import random

import pytest
import torch

from plonkish_tpu_torch import benchmark

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"

# name -> (module under pcs/, class, extra constructor arguments)
PCS = {
    "gemini": ("gemini", "Gemini"),
    "zeromorph": ("zeromorph", "Zeromorph"),
    "ipa": ("ipa", "MultilinearIpa"),
    "hyrax": ("hyrax", "MultilinearHyrax"),
    "brakedown": ("brakedown", "MultilinearBrakedown"),
}


def make_pcs(name, package):
    """The PCS `name` of `package` ("plonkish_tpu_torch" on the CPU, or the
    reference "plonkish_tpu"), built as tests/test_golden_proofs.py builds
    it (Brakedown over BN254 Fr with the reduced-soundness test spec)."""
    mod, cls = PCS[name]
    pcs_cls = getattr(importlib.import_module(f"{package}.pcs.{mod}"), cls)
    kwargs = {"device": "cpu"} if package == "plonkish_tpu_torch" else {}
    if name == "brakedown":
        code = importlib.import_module(f"{package}.pcs.brakedown_code")
        spec = importlib.import_module(
            f"{package}.fields.spec" if package == "plonkish_tpu_torch" else f"{package}.fields"
        ).BN254_FR
        return pcs_cls(spec, code.BRAKEDOWN_SPEC_TEST, **kwargs)
    return pcs_cls(**kwargs)


def _modules(package):
    hp = importlib.import_module(f"{package}.backend.hyperplonk")
    circuits = importlib.import_module(f"{package}.models.circuits")
    transcript = importlib.import_module(f"{package}.utils.transcript")
    return hp.HyperPlonk, circuits, transcript.Keccak256Transcript


def check_golden(name, k):
    """The port's HyperPlonk proof equals tests/golden/hyperplonk_<name>_k<k>.bin;
    the port's and the reference's verifiers accept it, and the port's rejects
    a flipped byte and a truncated proof."""
    HyperPlonk, circuits, Transcript = _modules("plonkish_tpu_torch")
    pcs = make_pcs(name, "plonkish_tpu_torch")
    spec = pcs.field_spec
    ci, circuit = circuits.rand_vanilla_plonk_circuit(spec, k, random.Random(1), random.Random(2))
    backend = HyperPlonk(pcs)
    pp, vp = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    tr = Transcript(spec)
    backend.prove(pp, circuit, tr)
    proof = tr.into_proof()
    assert proof == (GOLDEN / f"hyperplonk_{name}_k{k}.bin").read_bytes()
    backend.verify(vp, circuit.instances(), Transcript.from_proof(spec, proof))

    RefHyperPlonk, ref_circuits, RefTranscript = _modules("plonkish_tpu")
    ref_pcs = make_pcs(name, "plonkish_tpu")
    ref_ci, ref_circuit = ref_circuits.rand_vanilla_plonk_circuit(
        ref_pcs.field_spec, k, random.Random(1), random.Random(2))
    ref = RefHyperPlonk(ref_pcs)
    _, ref_vp = ref.preprocess(ref.setup(ref_ci, random.Random(0)), ref_ci)
    ref.verify(ref_vp, ref_circuit.instances(), RefTranscript.from_proof(ref_pcs.field_spec, proof))

    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 0x01
    with pytest.raises((ValueError, EOFError, AssertionError)):
        backend.verify(vp, circuit.instances(), Transcript.from_proof(spec, bytes(bad)))
    with pytest.raises((ValueError, EOFError, AssertionError)):
        backend.verify(vp, circuit.instances(), Transcript.from_proof(spec, proof[:-32]))


def _commit_open(package, name, k):
    """Commit to a random polynomial of 2^k evaluations, open it at a
    transcript point and verify: (proof bytes, commitment) of `package`."""
    pcs = make_pcs(name, package)
    spec = pcs.field_spec
    fp = importlib.import_module(f"{package}.fields.host").Fp
    ml = importlib.import_module(f"{package}.poly.multilinear").MLPoly
    Transcript = importlib.import_module(f"{package}.utils.transcript").Keccak256Transcript
    rng = random.Random(42 + k)
    n = 1 << k
    pp, vp = pcs.trim(pcs.setup(n, 1, random.Random(k)), n, 1)
    values = [fp(rng.randrange(spec.p), spec) for _ in range(n)]
    poly = ml.from_fps(spec, values, "cpu") if package == "plonkish_tpu_torch" \
        else ml.from_fps(spec, values)
    tr = Transcript(spec)
    comm = pcs.commit_and_write(pp, poly, tr)
    point = tr.squeeze_challenges(k)
    value = poly.evaluate(point)
    tr.write_field_element(value)
    pcs.open(pp, poly, comm, point, value, tr)
    proof = tr.into_proof()
    r = Transcript.from_proof(spec, proof)
    comm_r = pcs.read_commitments(vp, 1, r)[0]
    point_r = r.squeeze_challenges(k)
    pcs.verify(vp, comm_r, point_r, r.read_field_element(), r)
    return proof, comm


def check_round_trip(name, k):
    """Equal commitments (the first bytes of the proof) and equal proofs."""
    proof, _ = _commit_open("plonkish_tpu_torch", name, k)
    ref_proof, _ = _commit_open("plonkish_tpu", name, k)
    assert proof == ref_proof


def check_harness(name, tmp_path, monkeypatch):
    """``--system pcs --pcs <name>`` on the CPU writes its row."""
    monkeypatch.chdir(tmp_path)
    benchmark.main(["--device", "cpu", "--system", "pcs", "--pcs", name, "--k", "4..5",
                    "--samples", "1"])
    lines = (tmp_path / f"target/bench_torch/pcs_{name}").read_text().splitlines()
    notes = [line for line in lines if line.startswith("#")]
    rows = [line.split(",") for line in lines if not line.startswith("#")]
    assert len(notes) == 1 and f"pcs={name} device=cpu" in notes[0]
    assert len(rows) == 1 and int(rows[0][0]) == 4 and all(float(v) > 0 for v in rows[0][1:])


def test_golden_gemini_k5():
    check_golden("gemini", 5)


@pytest.mark.parametrize("k", [4, 5, 6])
def test_commit_open_equals_reference(k):
    check_round_trip("gemini", k)


def test_harness_pcs_gemini(tmp_path, monkeypatch):
    check_harness("gemini", tmp_path, monkeypatch)
