"""The port's circuit builder (plonkish_tpu_torch/frontend/builder.py) against
the reference's: the five circuit shapes of tests/test_frontend.py, built
through each package's builder from the same assignments, give equal
circuit infos (k, instances, preprocess polynomials, witness counts,
challenges, constraints, lookups, permutation cycles, max degree) and equal
witnesses in every phase; the port proves and verifies each that the
reference proves, and rejects a copy violation.

`circuit_key`, `assert_same_info` and `assert_same_witness` serve
test_torch_sha256.py and test_torch_aggregation.py too."""

import dataclasses
import importlib
import random

import pytest
import torch

torch.set_num_threads(1)

PORT, REF = "plonkish_tpu_torch", "plonkish_tpu"


def circuit_key(x):
    """A package-free value of an expression, a field element, a list of
    them or a plain value: dataclasses by their class name and fields."""
    if hasattr(x, "spec") and hasattr(x, "v") and not dataclasses.is_dataclass(x):
        return ("Fp", int(x))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            circuit_key(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(circuit_key(v) for v in x)
    return x


def assert_same_info(ours, theirs):
    assert ours.k == theirs.k
    assert list(ours.num_instances) == list(theirs.num_instances)
    assert list(ours.num_witness_polys) == list(theirs.num_witness_polys)
    assert list(ours.num_challenges) == list(theirs.num_challenges)
    assert ours.max_degree == theirs.max_degree
    assert len(ours.preprocess_polys) == len(theirs.preprocess_polys)
    for i, (a, b) in enumerate(zip(ours.preprocess_polys, theirs.preprocess_polys)):
        assert [int(v) for v in a] == [int(v) for v in b], f"preprocess poly {i}"
    assert circuit_key(ours.constraints) == circuit_key(theirs.constraints)
    assert circuit_key(ours.lookups) == circuit_key(theirs.lookups)
    assert circuit_key(ours.permutations) == circuit_key(theirs.permutations)
    assert ours.field_spec.p == theirs.field_spec.p


def assert_same_witness(ours, theirs, phases=1, challenge=None):
    """Instances and every phase's witness columns, each phase given the
    challenge value `challenge` in each package's field type."""
    assert circuit_key(ours.instances()) == circuit_key(theirs.instances())
    for phase in range(phases):
        a, b = (c.synthesize(phase, [] if challenge is None else [_fp(pkg, challenge)])
                for c, pkg in ((ours, PORT), (theirs, REF)))
        assert [[int(v) for v in col] for col in a] == [[int(v) for v in col] for col in b], phase


def _fp(pkg, v):
    host = importlib.import_module(f"{pkg}.fields.host")
    spec = importlib.import_module(f"{pkg}.fields.spec").BN254_FR
    return host.Fp(v, spec)


# ---------------------------------------------------------------------------
# The five shapes of tests/test_frontend.py, written once over a package
# ---------------------------------------------------------------------------

def vanilla_gate_with_copies(pkg):
    b_mod = importlib.import_module(f"{pkg}.frontend.builder")
    Fp = importlib.import_module(f"{pkg}.fields.host").Fp
    spec = importlib.import_module(f"{pkg}.fields.spec").BN254_FR
    b = b_mod.CircuitBuilder(4, spec)
    q_mul, q_c = b.fixed_column(), b.fixed_column()
    w_l, w_r, w_o = b.advice_column(), b.advice_column(), b.advice_column()
    b.gate("mul", lambda q: q(q_mul.cur()) * (q(w_l.cur()) * q(w_r.cur()) - q(w_o.cur()))
           + q(q_c.cur()) * (q(w_l.cur()) - q(w_r.cur())))
    acc = Fp(3, spec)
    fixed, witness = {}, {}
    for row in range(6):
        fixed[(0, row)] = Fp.one(spec)
        witness[(0, row)] = acc
        witness[(1, row)] = acc
        acc = acc * acc
        witness[(2, row)] = acc
        b.copy(b_mod.Cell(w_l, row), b_mod.Cell(w_r, row))
        if row > 0:
            b.copy(b_mod.Cell(w_o, row - 1), b_mod.Cell(w_l, row))
    return b.build(fixed, [], lambda phase, ch: witness)


def copy_violation(pkg):
    b_mod = importlib.import_module(f"{pkg}.frontend.builder")
    Fp = importlib.import_module(f"{pkg}.fields.host").Fp
    spec = importlib.import_module(f"{pkg}.fields.spec").BN254_FR
    b = b_mod.CircuitBuilder(3, spec)
    q = b.fixed_column()
    w_a, w_b = b.advice_column(), b.advice_column()
    b.gate("noop", lambda qq: qq(q.cur()) * (qq(w_a.cur()) - qq(w_a.cur())))
    b.copy(b_mod.Cell(w_a, 0), b_mod.Cell(w_b, 0))
    witness = {(0, 0): Fp(7, spec), (1, 0): Fp(8, spec)}  # violates the copy
    return b.build({}, [], lambda phase, ch: witness)


def lookup_range_check(pkg):
    b_mod = importlib.import_module(f"{pkg}.frontend.builder")
    Fp = importlib.import_module(f"{pkg}.fields.host").Fp
    spec = importlib.import_module(f"{pkg}.fields.spec").BN254_FR
    k, limit = 4, 8
    b = b_mod.CircuitBuilder(k, spec)
    q_range, t_col = b.fixed_column(), b.fixed_column()
    w = b.advice_column()
    b.lookup("range", [(lambda q: q(q_range.cur()) * q(w.cur()), lambda q: q(t_col.cur()))])
    b.gate("noop", lambda q: q(q_range.cur()) * (q(w.cur()) - q(w.cur())))
    rng = random.Random(6)
    fixed = {(1, row): Fp(row, spec) for row in range(limit)}
    witness = {}
    for row in range((1 << k) - 2):
        fixed[(0, row)] = Fp.one(spec)
        witness[(0, row)] = Fp(rng.randrange(limit), spec)
    return b.build(fixed, [], lambda phase, ch: witness)


def instance_column(pkg):
    b_mod = importlib.import_module(f"{pkg}.frontend.builder")
    Fp = importlib.import_module(f"{pkg}.fields.host").Fp
    spec = importlib.import_module(f"{pkg}.fields.spec").BN254_FR
    b = b_mod.CircuitBuilder(3, spec)
    pi = b.instance_column(2)
    q_pub = b.fixed_column()
    w = b.advice_column()
    b.gate("expose", lambda q: q(q_pub.cur()) * (q(w.cur()) - q(pi.cur())))
    values = [Fp(11, spec), Fp(22, spec)]
    fixed = {(0, 0): Fp.one(spec), (0, 1): Fp.one(spec)}
    witness = {(0, 0): values[0], (0, 1): values[1]}
    return b.build(fixed, [values], lambda phase, ch: witness)


def two_phase_challenge(pkg):
    b_mod = importlib.import_module(f"{pkg}.frontend.builder")
    Fp = importlib.import_module(f"{pkg}.fields.host").Fp
    spec = importlib.import_module(f"{pkg}.fields.spec").BN254_FR
    b = b_mod.CircuitBuilder(4, spec)
    q = b.fixed_column()
    w0, w1 = b.advice_column(phase=0), b.advice_column(phase=1)
    theta = b.challenge(phase=0)
    b.gate("phase", lambda qf: qf(q.cur()) * (qf(w1.cur()) - qf(theta) * qf(w0.cur())))
    rng = random.Random(11)
    rows = 5
    fixed = {(0, r): Fp.one(spec) for r in range(rows)}
    w0_vals = {r: Fp(rng.randrange(spec.p), spec) for r in range(rows)}

    def witness_fn(phase, challenges):
        if phase == 0:
            return {(0, r): v for r, v in w0_vals.items()}
        th = challenges[b.challenge_index(theta)]
        return {(1, r): th * v for r, v in w0_vals.items()}

    return b.build(fixed, [], witness_fn)


SHAPES = {
    "vanilla_gate_with_copies": vanilla_gate_with_copies,
    "copy_violation": copy_violation,
    "lookup_range_check": lookup_range_check,
    "instance_column": instance_column,
    "two_phase_challenge": two_phase_challenge,
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_circuit_info_and_witness_equal_reference(shape):
    ours_info, ours = SHAPES[shape](PORT)
    ref_info, ref = SHAPES[shape](REF)
    assert_same_info(ours_info, ref_info)
    assert_same_witness(ours, ref, phases=len(ours_info.num_witness_polys), challenge=123456789)


def _prove(info, circuit):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    backend = HyperPlonk(MultilinearKzg(device="cpu"))
    pp, vp = backend.preprocess(backend.setup(info, random.Random(0)), info)
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, circuit, tr)
    return backend, vp, Keccak256Transcript.from_proof(BN254_FR, tr.into_proof())


@pytest.mark.parametrize("shape", ["vanilla_gate_with_copies", "lookup_range_check",
                                   "instance_column", "two_phase_challenge"])
def test_built_circuit_proves(shape):
    info, circuit = SHAPES[shape](PORT)
    assert info.is_well_formed()
    backend, vp, tr = _prove(info, circuit)
    backend.verify(vp, circuit.instances(), tr)


def test_copy_violation_rejected():
    info, circuit = copy_violation(PORT)
    with pytest.raises((ValueError, AssertionError)):
        backend, vp, tr = _prove(info, circuit)
        backend.verify(vp, circuit.instances(), tr)
