"""The benchmark's parts on their own: the plain reference against the
port's answers (and against answers with one byte changed), the frozen
counts against hand-worked cases, the circuit generator, the trace
reduction, and the lookup of traffic and metric files by name."""

import random

import numpy as np
import pytest

from proofbench import generator, harness, trace, yardstick
from proofbench.circuits import vanilla_plonk
from proofbench.reference import hyperplonk as ref
from proofbench.reference import mlkzg
from proofbench.reference.curve import G1

K, SEED, SRS_SEED = 4, 2**31 + 99, 1


@pytest.fixture(scope="module")
def proved():
    """A circuit of the frozen generator, two of its witnesses and the
    port's proof of the first, on the CPU."""
    from plonkish_tpu_torch.backend.circuit import MockCircuit
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.models.circuits import vanilla_plonk_circuit_info
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    c = vanilla_plonk.circuit(K, SEED)
    w = [vanilla_plonk.witness(c, SEED, j) for j in range(2)]

    def fps(values):
        return [Fp(v, BN254_FR) for v in values]

    info = vanilla_plonk_circuit_info(BN254_FR, K, K, [fps(s) for s in c.selectors], c.cycles)
    backend = HyperPlonk(MultilinearKzg(device="cpu"))
    pp, _ = backend.preprocess(backend.setup(info, random.Random(SRS_SEED)), info)
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, MockCircuit([fps(w[0][0])], [fps(col) for col in w[0][1]]), tr)
    s = mlkzg.trapdoor(K, SRS_SEED)
    eq = mlkzg.eq_table(s)
    vk = ref.verifier_key(ref.vanilla_plonk_info(K, K, [6, 7, 8]),
                          [mlkzg.commit(col, eq) for col in c.selectors],
                          [mlkzg.commit(col, eq) for col in c.sigmas], s)
    comms = [[mlkzg.commit(col, eq) for col in wj[1]] for wj in w]
    return c, w, tr.into_proof(), vk, comms, pp


def test_reference_accepts_the_ports_proof(proved):
    c, w, proof, vk, comms, _ = proved
    ref.verify(vk, [w[0][0]], proof, comms[0])


@pytest.mark.parametrize("where", [0, 64, 200, 0.5, -40, -1])
def test_reference_rejects_a_proof_with_one_byte_changed(proved, where):
    c, w, proof, vk, comms, _ = proved
    i = int(where * len(proof)) if isinstance(where, float) else where % len(proof)
    bad = bytearray(proof)
    bad[i] ^= 0x10
    with pytest.raises((ValueError, EOFError)):
        ref.verify(vk, [w[0][0]], bytes(bad), comms[0])


def test_reference_rejects_other_instances_or_witness(proved):
    c, w, proof, vk, comms, _ = proved
    with pytest.raises(ValueError):
        ref.verify(vk, [w[1][0]], proof, comms[0])
    with pytest.raises(ValueError):
        ref.verify(vk, [w[0][0]], proof, comms[1])
    with pytest.raises((ValueError, EOFError)):
        ref.verify(vk, [w[0][0]], proof + b"\x00", comms[0])


def test_trapdoor_commitment_matches_the_ports_msm(proved):
    """The port's commitment of a polynomial is [f(s)] G; one changed byte
    of the evaluations changes the reference's."""
    import torch
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    pp = proved[5].pcs
    g = torch.Generator().manual_seed(3)
    evals = torch.randint(-(1 << 31), 1 << 31, (1 << K, 8), dtype=torch.int32, generator=g)
    evals[:, 7] = torch.randint(0, mlkzg.BN254_R >> 224, (1 << K,), dtype=torch.int32, generator=g)
    point = MultilinearKzg(device="cpu").commit(pp, MLPoly(BN254_FR, evals))
    eq = mlkzg.eq_table(mlkzg.trapdoor(K, SRS_SEED))
    limbs = evals.numpy().copy()
    assert mlkzg.commit_montgomery(limbs, eq) == (int(point.x), int(point.y))
    limbs.view(np.uint8)[5, 3] ^= 1
    assert mlkzg.commit_montgomery(limbs, eq) != (int(point.x), int(point.y))


def test_msm_least_work_hand_worked():
    # n = 4: 8 GLV halves of 127 bits; c = 4 gives 32 windows of 8 buckets,
    # 256 entries filling all 256 buckets: 256 - 256 + 2 * 256 = 512
    # additions, the fewest of any c (c = 3: 516, c = 5: 832).
    ops, nbytes = yardstick.msm_least_work(4)
    assert ops == (512 * 6 + 4) * 256 and nbytes == 4 * 96
    # n = 2^20: c = 19, 7 windows of 2^18 buckets: 2^21 * 7 entries less
    # the 7 * 2^18 first ones, plus 2 * 7 * 2^18 for the reduction (c = 16:
    # 8 windows, 2^24 + 2^18; c = 20: 7 windows, 7 * 2^21 + 7 * 2^19).
    ops, nbytes = yardstick.msm_least_work(1 << 20)
    assert ops == ((7 * 2**21 + 7 * 2**18) * 6 + 2**20) * 256
    assert nbytes == 2**20 * 96
    seconds = yardstick.least_seconds((ops, nbytes))
    assert seconds == pytest.approx(ops / (132 * 64 * 1.98e9))
    assert 1.5e-3 < seconds < 1.6e-3
    # without the endomorphism: 254-bit scalars need more
    assert yardstick.msm_least_work(1 << 20, glv=False)[0] > ops


def test_generator_circuit_is_satisfied_and_seeded():
    c = vanilla_plonk.circuit(8, 7)
    w0, w1 = (vanilla_plonk.witness(c, 7, j) for j in range(2))
    assert vanilla_plonk.satisfied(c, *w0) and vanilla_plonk.satisfied(c, *w1)
    assert w0[1][0] != w1[1][0] and w0[0] != w1[0]
    again = vanilla_plonk.circuit(8, 7)
    assert again.cycles == c.cycles and again.selectors == c.selectors
    assert vanilla_plonk.witness(again, 7, 1) == w1
    assert vanilla_plonk.circuit(8, 8).selectors != c.selectors
    broken = [list(col) for col in w0[1]]
    broken[2][3] += 1
    assert not vanilla_plonk.satisfied(c, w0[0], broken)
    # every sigma is a permutation of the cells' ids
    ids = sorted(v for sigma in c.sigmas for v in sigma)
    assert ids == list(range(3 << 8))


def test_trace_reduction_hand_worked():
    spans = [("prove", -1, 0.0, 10.0), ("zero_check", 0, 2.0, 6.0), ("rounds", 1, 3.0, 4.0)]
    device = [(1.0, 2.5), (3.5, 3.75), (7.0, 8.0)]
    idle = trace.idle_by_span(device, spans, 0.0, 10.0)
    assert idle == pytest.approx({"prove": 1.0 + 1.0 + 2.0, "zero_check": 0.5 + 2.0,
                                  "rounds": 0.75})
    assert trace.union_seconds(device + [(1.5, 3.0)]) == pytest.approx(2.0 + 0.25 + 1.0)
    outside = trace.idle_by_span([], [("prove", -1, 1.0, 2.0)], 0.0, 3.0)
    assert outside == pytest.approx({trace.BETWEEN: 2.0, "prove": 1.0})


def test_files_are_found_by_name(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic" / "burst.json").write_text(
        '{"op": "commit", "inputs": "fresh", "check_sample": 2, "traced_requests": 3}')
    (tmp_path / "metrics" / "twice.count.py").write_text("def read(ctx):\n    return 2.0 * ctx\n")
    t = generator.load("burst", root=str(tmp_path))
    reqs = [r for r, _ in zip(generator.stream(t), range(4))]
    assert [(r.index, r.input_index) for r in reqs] == [(0, 0), (1, 1), (2, 2), (3, 3)]
    assert generator.sample(t, 5, 10) == generator.sample(t, 5, 10) and len(generator.sample(t, 5, 10)) == 2
    assert harness.reader("twice.count", root=str(tmp_path)).read(3) == 6.0


def test_a_mix_with_a_key_the_generator_does_not_read_is_refused(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "sizes.json").write_text(
        '{"op": "commit", "inputs": "fresh", "log_sizes": [10, 12], "traced_requests": 3}')
    with pytest.raises(ValueError, match="log_sizes"):
        generator.load("sizes", root=str(tmp_path))


def test_one_hot_commitment_is_the_eq_tables_entry():
    s = mlkzg.trapdoor(K, SRS_SEED)
    eq = mlkzg.eq_table(s)
    for b in (0, 5, (1 << K) - 1):
        assert mlkzg.eq_at(s, b) == eq[b]
        assert mlkzg.commit_one_hot(s, b) == mlkzg.commit([int(i == b) for i in range(1 << K)], eq)


def test_every_metric_of_the_benchmark_has_a_reader_and_every_cell_its_files():
    spec = harness.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    for w in spec["workloads"]:
        generator.load(w["traffic"])
        _, c = harness.cell(spec, w["name"])
        assert harness.system_class(__import__("json").load(
            open(harness.REPO + "/" + c["file"]))["system"])


def test_pool_inputs_never_repeat_back_to_back():
    t = generator.load("prove")
    reqs = [r for r, _ in zip(generator.stream(t), range(7))]
    js = [0] + [r.input_index for r in reqs]  # the warm-up takes input 0
    assert all(a != b for a, b in zip(js, js[1:]))


def test_curve_scalar_multiplication():
    g = G1.gen
    assert G1.mul(g, 0) is None and G1.mul(g, 1) == g
    assert G1.add(G1.mul(g, 5), G1.mul(g, 7)) == G1.mul(g, 12)
    assert G1.add(g, G1.neg(g)) is None and G1.mul(g, G1.scalar.p) is None
