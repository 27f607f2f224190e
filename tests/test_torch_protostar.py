"""Protostar and Sangria folding in the port on the CPU against the JAX
package on its cpp backend, in the shapes of tests/test_protostar.py (but its
slow sha256 fold): the two packages fold the same circuits side by side, and
after every fold the port's accumulator equals the reference's (instances,
commitments, challenges, u, the compressed e sum, every witness polynomial
and the e polynomial) and so do the fold's transcript bytes; the decider
proofs are equal byte for byte, each package's verifier accepts the other's
proof and rejects it with a flipped byte or cut short.  The vanilla
Protostar decider at k = 3 is tests/golden/protostar_kzg_decider_k3.bin.
Checkpoints written by either package load in the other and continue to the
same decider proof; a changed byte is refused.

The helpers here serve test_torch_protostar_pcs.py and
test_torch_protostar_sangria.py too."""

import importlib
import pathlib
import random

import numpy as np
import pytest
import torch

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden"
PORT, REF = "plonkish_tpu_torch", "plonkish_tpu"
PCS = {
    "kzg": ("kzg", "MultilinearKzg"),
    "ipa": ("ipa", "MultilinearIpa"),
    "gemini": ("gemini", "Gemini"),
    "zeromorph": ("zeromorph", "Zeromorph"),
}
CIRCUITS = {
    "vanilla": "rand_vanilla_plonk_circuit",
    "lookup": "rand_vanilla_plonk_with_lookup_circuit",
}


class Side:
    """One package's scheme, params and circuits for a shape: the circuit
    info from witness seed 0 and the folded circuits from seeds 100, 101, ...
    (tests/test_protostar.py::run_accumulation_scheme)."""

    def __init__(self, package, system, pcs_name, num_vars, circuit, num_circuits=3):
        mod, cls = PCS[pcs_name]
        pcs = getattr(importlib.import_module(f"{package}.pcs.{mod}"), cls)(
            **({"device": "cpu"} if package == PORT else {}))
        acc_mod = importlib.import_module(f"{package}.accumulation.protostar")
        circuits = importlib.import_module(f"{package}.models.circuits")
        self.Transcript = importlib.import_module(f"{package}.utils.transcript").Keccak256Transcript
        self.scheme = acc_mod.Protostar(pcs) if system == "protostar" else acc_mod.Sangria(pcs)
        self.spec = pcs.field_spec
        fn = getattr(circuits, CIRCUITS[circuit])

        def make(seed):
            return fn(self.spec, num_vars, random.Random(42), random.Random(seed))

        circuit_info, _ = make(0)
        self.circuits = [make(100 + i)[1] for i in range(num_circuits)]
        param = self.scheme.setup(circuit_info, random.Random(0))
        self.pp, self.vp = self.scheme.preprocess(param, circuit_info)
        self.acc = self.scheme.init_accumulator(self.pp)

    def fold(self, i) -> bytes:
        tr = self.Transcript(self.spec)
        self.scheme.prove_accumulation_from_nark(self.pp, self.acc, self.circuits[i], tr)
        return tr.into_proof()

    def decide(self):
        """(the accumulator's instance before the last fold, the decider proof)."""
        before = self.acc.instance.clone()
        tr = self.Transcript(self.spec)
        self.scheme.prove_decider_with_last_nark(self.pp, self.acc, self.circuits[-1], tr)
        return before, tr.into_proof()

    def verify(self, before, proof):
        self.scheme.verify_decider_with_last_nark(
            self.vp, before.clone(), self.circuits[-1].instances(),
            self.Transcript.from_proof(self.spec, proof),
        )


def decider_state(spec, system, circuit, num_vars, device, seed):
    """(prover state, EvaluationsProver) of the decider's sum-check of
    `system` over `circuit`'s structure, on random tables, challenges, y and
    sum: the K3 tape the decider runs."""
    from plonkish_tpu_torch.accumulation.protostar import ProtostarStrategy, protostar_expressions
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.models import circuits
    from plonkish_tpu_torch.piop import sum_check as sc
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    rng = random.Random(seed)
    info, _ = getattr(circuits, CIRCUITS[circuit])(spec, 4, random.Random(42), random.Random(0))
    strategy = {"protostar": ProtostarStrategy.Compressing,
                "sangria": ProtostarStrategy.NoCompressing}[system]
    exprs = protostar_expressions(info, strategy)
    expr = exprs.expression
    polys = [MLPoly.from_ints(spec, [rng.randrange(spec.p) for _ in range(1 << num_vars)], device)
             for _ in range(1 + max(q.poly for q in expr.used_query()))]
    # the folded challenges and u, then beta, gamma and alpha
    challenges = [Fp(rng.randrange(spec.p), spec) for _ in range(exprs.num_folding_challenges + 4)]
    y = [Fp(rng.randrange(spec.p), spec) for _ in range(num_vars)]
    state = sc.ProverState(spec, num_vars, Fp(rng.randrange(spec.p), spec),
                           sc.VirtualPolynomial(expr, polys, challenges, [y]))
    return state, sc.EvaluationsProver(state)


def reference_layout(acc) -> dict:
    """A reference accumulator in the form of convert.accumulator_to_reference."""
    def comm(c):
        if isinstance(c, (list, tuple)):
            return [comm(x) for x in c]
        if hasattr(c, "root"):
            return c.root
        return (0, 0, True) if c.is_identity() else (int(c.x), int(c.y), False)

    inst = acc.instance
    return {
        "instances": [[int(v) for v in col] for col in inst.instances],
        "witness_comms": [comm(c) for c in inst.witness_comms],
        "challenges": [int(c) for c in inst.challenges],
        "u": int(inst.u),
        "e_comm": comm(inst.e_comm),
        "compressed_e_sum": None if inst.compressed_e_sum is None else int(inst.compressed_e_sum),
        "witness_polys": [np.asarray(p.evals, dtype=np.uint32) for p in acc.witness_polys],
        "e_poly": np.asarray(acc.e_poly.evals, dtype=np.uint32),
    }


def assert_same_accumulator(port_acc, ref_acc, when):
    from plonkish_tpu_torch import convert

    got, want = convert.accumulator_to_reference(port_acc), reference_layout(ref_acc)
    assert got.keys() == want.keys()
    for key in got:
        if key == "witness_polys":
            assert len(got[key]) == len(want[key]), when
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                assert np.array_equal(g, w), f"{when}: witness poly {i}"
        elif key == "e_poly":
            assert np.array_equal(got[key], want[key]), f"{when}: e poly"
        else:
            assert got[key] == want[key], f"{when}: {key}"


def expect_rejected(side, before, proof):
    for bad in (bytes(b ^ (i == len(proof) // 3) for i, b in enumerate(proof)), proof[:-32]):
        with pytest.raises((ValueError, EOFError)):
            side.verify(before, bad)


def check_scheme(system, pcs_name, num_vars, circuit, golden=None):
    """Fold the shape's circuits in both packages side by side, then decide:
    equal accumulators and fold transcripts after every fold, equal decider
    proofs, both verifiers accepting and rejecting."""
    port = Side(PORT, system, pcs_name, num_vars, circuit)
    ref = Side(REF, system, pcs_name, num_vars, circuit)
    assert_same_accumulator(port.acc, ref.acc, "init")
    for i in range(len(port.circuits) - 1):
        assert port.fold(i) == ref.fold(i), f"fold {i} transcript"
        assert_same_accumulator(port.acc, ref.acc, f"after fold {i}")
    port_before, proof = port.decide()
    ref_before, want = ref.decide()
    assert proof == want
    assert_same_accumulator(port.acc, ref.acc, "after the last fold")
    if golden:
        assert proof == (GOLDEN / golden).read_bytes()
    port.verify(port_before, proof)
    ref.verify(ref_before, proof)
    expect_rejected(port, port_before, proof)
    expect_rejected(ref, ref_before, proof)


def test_protostar_vanilla_k3_golden():
    check_scheme("protostar", "kzg", 3, "vanilla", golden="protostar_kzg_decider_k3.bin")


def test_protostar_vanilla_k5():
    check_scheme("protostar", "kzg", 5, "vanilla")


@pytest.mark.parametrize("num_vars", [3, 5])
def test_protostar_lookup(num_vars):
    check_scheme("protostar", "kzg", num_vars, "lookup")


def test_checkpoint_crosses_packages():
    """A checkpoint after one fold, saved by either package, loads in the
    other and continues to the reference's own decider proof; a changed byte
    of it is refused by both loaders."""
    from plonkish_tpu.utils import serde as ref_serde
    from plonkish_tpu_torch.utils import serde

    ref = Side(REF, "protostar", "kzg", 3, "vanilla")
    ref.fold(0)
    ref_blob = ref_serde.save(ref.acc)
    ref.fold(1)
    _, want = ref.decide()

    port = Side(PORT, "protostar", "kzg", 3, "vanilla")
    port.fold(0)
    port_blob = serde.save(port.acc)

    # the port's checkpoint, continued by the reference
    cont = Side(REF, "protostar", "kzg", 3, "vanilla")
    cont.acc = ref_serde.load(port_blob)
    cont.fold(1)
    assert cont.decide()[1] == want

    # the reference's checkpoint, continued by the port
    port.acc = serde.load(ref_blob, "cpu")
    assert port.acc.e_poly.device.type == "cpu"
    port.fold(1)
    before, proof = port.decide()
    assert proof == want
    port.verify(before, proof)

    for blob in (ref_blob, port_blob):
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 1
        for load in (lambda b: serde.load(b, "cpu"), ref_serde.load):
            with pytest.raises(ValueError, match="integrity"):
                load(bytes(bad))
    with pytest.raises(ValueError, match="not a plonkish_tpu checkpoint"):
        serde.load(b"x" + port_blob, "cpu")


def test_accumulator_round_trips_through_convert():
    """convert.accumulator_from_reference carries a reference accumulator
    over exactly, and folding on from it gives the reference's next fold."""
    from plonkish_tpu_torch import convert

    ref = Side(REF, "protostar", "kzg", 3, "lookup")
    ref.fold(0)
    port = Side(PORT, "protostar", "kzg", 3, "lookup")
    port.acc = convert.accumulator_from_reference(ref.acc, "cpu")
    assert_same_accumulator(port.acc, ref.acc, "carried over")
    assert port.fold(1) == ref.fold(1)
    assert_same_accumulator(port.acc, ref.acc, "folded on")
