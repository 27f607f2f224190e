"""The sharded prover (``plonkish_tpu_torch.parallel``) on the CPU: groups of
2 and 4 ranks over gloo, each rank a process with one torch thread, against
the JAX package run unsharded on its cpp backend.  Inputs come from numpy
seeds; every comparison is exact.

Each group is spawned once per world size (the ``ranks`` fixture) and runs
every rank program below; the tests read its results.  The rank programs
import the port only: each rank imports this module again, so the JAX
package is imported inside the tests, never at module level."""

import random

import numpy as np
import pytest
import torch

from plonkish_tpu_torch import convert, parallel
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.spec import BN254_FR

torch.set_num_threads(1)

P = BN254_FR.p
WORLDS = [2, 4]
K_STEP = 5  # the round step's columns
K_SC = 5  # the sum-checks
K_PROOF = 6  # the HyperPlonk proofs
CHALLENGE = 0xC0FFEE123456789
MSM_CASES = {"n64_16bit": (64, 16), "n64_full": (64, 254), "n6_full": (6, 254)}
BRAKEDOWN_ROWS = 8  # the commit's matrix: 8 rows of 32 (its code at 5 variables)


def _ints(n, seed, modulus=P):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % modulus for row in words]


# ---------------------------------------------------------------------------
# What each rank runs (the port only)
# ---------------------------------------------------------------------------

def _round_step(mesh):
    from plonkish_tpu_torch.parallel.sharded import sharded_round_step

    n = 1 << K_STEP
    polys = limb.from_canonical_ints(BN254_FR, _ints(9 * n, 11)).reshape(9, n, 8)
    total, folded = sharded_round_step(BN254_FR, mesh, polys, limb.const(BN254_FR, CHALLENGE))
    return (limb.to_canonical_ints(BN254_FR, total[None])[0],
            limb.to_canonical_ints(BN254_FR, folded.reshape(-1, 8)))


def _msm_points(point_cls, curve, n, seed):
    """n points k_i * G with k_i from a numpy seed (either package's curve)."""
    g = point_cls.generator(curve)
    return [g.scalar_mul(1 + k) for k in _ints(n, seed, curve.scalar.p - 1)]


def _msms(mesh):
    from plonkish_tpu_torch.curves import device as cdev
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.msm import variable_base_msm
    from plonkish_tpu_torch.curves.specs import BN254_G1

    out = {}
    for name, (n, bits) in MSM_CASES.items():
        pts = _msm_points(AffinePoint, BN254_G1, n, 300 + n)
        scalars = _ints(n, 400 + bits, 1 << bits if bits < 254 else BN254_G1.scalar.p)
        before = mesh.taken["msm"]
        got = variable_base_msm(BN254_G1, limb.from_ints(scalars),
                                cdev.affine_from_host(BN254_G1, pts, "cpu"))
        out[name] = ((int(got.x), int(got.y)), mesh.taken["msm"] - before)
    return out


def _sum_check_inputs(name, ex, circuits, Fp, spec, from_ints):
    """The expression and VirtualPolynomial parts of one case, for either
    package (passed its modules)."""
    n = 1 << K_SC
    if name == "vanilla":
        expr = circuits.vanilla_plonk_expression(spec, K_SC)
    else:  # the rotation-bearing expression of the dry run
        w0, w2 = (ex.Polynomial(ex.Query(i, ex.Rotation(0))) for i in (0, 2))
        w1_next = ex.Polynomial(ex.Query(1, ex.Rotation(1)))
        expr = ex.CommonPoly(ex.EqXY(0)) * (w0 * w1_next + w2)
    num_polys = 1 + max(q.poly for q in expr.used_query())
    polys = [from_ints(spec, _ints(n, 600 + i)) for i in range(num_polys)]
    challenges = [Fp(v, spec) for v in _ints(3, 700)]
    ys = [[Fp(v, spec) for v in _ints(K_SC, 800)]]
    return expr, polys, challenges, ys


def _sum_checks(mesh):
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.models import circuits
    from plonkish_tpu_torch.piop import sum_check as sc
    from plonkish_tpu_torch.poly.multilinear import MLPoly
    from plonkish_tpu_torch.utils import expression as ex
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    out = {}
    for name in ("vanilla", "rotation"):
        expr, polys, ch, ys = _sum_check_inputs(
            name, ex, circuits, Fp, BN254_FR, lambda spec, v: MLPoly.from_ints(spec, v, "cpu"))
        before = mesh.taken["sum_check"]
        tr = Keccak256Transcript(BN254_FR)
        sc.ClassicSumCheck.evaluations().prove(
            BN254_FR, K_SC, sc.VirtualPolynomial(expr, polys, ch, ys), Fp.zero(BN254_FR), tr)
        out[name] = (tr.into_proof(), mesh.taken["sum_check"] - before)
    return out


def _pcs(name):
    from plonkish_tpu_torch.pcs.brakedown import MultilinearBrakedown
    from plonkish_tpu_torch.pcs.brakedown_code import BRAKEDOWN_SPEC_TEST
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg

    if name == "kzg":
        return MultilinearKzg(device="cpu")
    return MultilinearBrakedown(BN254_FR, BRAKEDOWN_SPEC_TEST, device="cpu")


def _hyperplonk(mesh):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    out = {}
    for name in ("kzg", "brakedown"):
        ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, K_PROOF, random.Random(1),
                                                 random.Random(2))
        backend = HyperPlonk(_pcs(name))
        pp, _ = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
        mesh.reset_stats()
        tr = Keccak256Transcript(BN254_FR)
        backend.prove(pp, circuit, tr)
        out[name] = (tr.into_proof(), dict(mesh.taken), mesh.collectives, mesh.bytes)
    return out


def _brakedown_code(mod, spec):
    return mod.Brakedown.new_multilinear(spec, mod.BRAKEDOWN_SPEC_TEST, 5, 20, random.Random(9))


def _brakedown_commit(mesh):
    from plonkish_tpu_torch.pcs import brakedown, brakedown_code
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    code = _brakedown_code(brakedown_code, BN254_FR)
    pp = brakedown.BrakedownParams(num_vars=8, num_rows=BRAKEDOWN_ROWS, code=code)
    poly = MLPoly.from_ints(BN254_FR, _ints(256, 900), "cpu")
    before = mesh.taken["brakedown_commit"]
    comm = _pcs("brakedown").commit(pp, poly)
    return comm.root, comm.rows, comm.intermediate_hashes, mesh.taken["brakedown_commit"] - before


def _rank_program(mesh):
    return {
        "rank": mesh.rank,
        "round_step": _round_step(mesh),
        "msm": _msms(mesh),
        "sum_check": _sum_checks(mesh),
        "hyperplonk": _hyperplonk(mesh),
        "brakedown_commit": _brakedown_commit(mesh),
    }


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request):
    world = request.param
    results = parallel.spawn(_rank_program, world, "gloo", "cpu", threads=1,
                             timeout_s=120, deadline_s=400)
    assert [r["rank"] for r in results] == list(range(world))
    return world, results


# ---------------------------------------------------------------------------
# The reference, unsharded, on the cpp backend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_proofs():
    """The JAX package's HyperPlonk proofs at K_PROOF, verified by its
    verifier once (every rank's proof must equal these bytes)."""
    from plonkish_tpu.backend.hyperplonk import HyperPlonk
    from plonkish_tpu.fields import BN254_FR as REF_FR
    from plonkish_tpu.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu.pcs.brakedown import MultilinearBrakedown
    from plonkish_tpu.pcs.brakedown_code import BRAKEDOWN_SPEC_TEST
    from plonkish_tpu.pcs.kzg import MultilinearKzg
    from plonkish_tpu.utils.transcript import Keccak256Transcript

    out = {}
    for name, pcs in (("kzg", MultilinearKzg()),
                      ("brakedown", MultilinearBrakedown(REF_FR, BRAKEDOWN_SPEC_TEST))):
        ci, circuit = rand_vanilla_plonk_circuit(REF_FR, K_PROOF, random.Random(1),
                                                 random.Random(2))
        backend = HyperPlonk(pcs)
        pp, vp = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
        tr = Keccak256Transcript(REF_FR)
        backend.prove(pp, circuit, tr)
        proof = tr.into_proof()
        backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(REF_FR, proof))
        out[name] = proof
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,rank,n,block", [
    (2, 0, 8, (0, 4)), (2, 1, 8, (4, 8)), (4, 3, 16, (12, 16)),
    (4, 2, 8, (4, 6)),  # n == 2 * world: one pair a rank
    (4, 0, 6, None),  # does not divide
    (4, 0, 4, None),  # shorter than 2 * world
    (2, 1, 3, None),
])
def test_maybe_shard_noop_rules(world, rank, n, block):
    """The JAX no-op rules: no mesh, an axis that does not divide, or an
    axis shorter than 2 * world leave the tensor whole."""
    t = torch.arange(3 * n).reshape(n, 3)
    assert parallel.maybe_shard_rows(t) is t  # no mesh
    mesh = parallel.Mesh(group=None, rank=rank, world=world, backend="gloo",
                         device=torch.device("cpu"))
    with parallel.use_mesh(mesh):
        rows = parallel.maybe_shard_rows(t)
        cols = parallel.maybe_shard_axis(t.T, 1)
        row = t[0]
        assert parallel.maybe_shard_axis(row, 1) is row  # no such axis: whole
        got = parallel.row_block(n)
    assert parallel.get_mesh() is None
    if block is None:
        assert got is None and rows is t and cols.shape == t.T.shape
    else:
        assert (got.start, got.stop, got.total) == (*block, n)
        assert torch.equal(rows, t[block[0]:block[1]])
        assert torch.equal(cols, t.T[:, block[0]:block[1]])


@pytest.mark.parametrize("world,device,cards,backend", [
    (1, "cpu", 0, "gloo"), (4, "cpu", 8, "gloo"),
    (1, "cuda", 1, "nccl"), (2, "cuda", 2, "nccl"),
    (2, "cuda", 1, "gloo"),  # two ranks share the one card
])
def test_backend_for(world, device, cards, backend, monkeypatch):
    """NCCL with a card a rank; gloo on the CPU or where ranks share a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert parallel.backend_for(world, device) == backend


def test_make_mesh_one_rank_in_process():
    """A one-rank group in this process: the round step under it equals the
    unsharded step, and closing it leaves no group running."""
    import torch.distributed as dist

    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.parallel import sharded

    n = 1 << K_STEP
    polys = limb.from_canonical_ints(BN254_FR, _ints(9 * n, 11)).reshape(9, n, 8)
    challenge = limb.const(BN254_FR, CHALLENGE)
    mesh = sharded.make_mesh("gloo", device="cpu")
    try:
        assert (mesh.rank, mesh.world, mesh.device) == (0, 1, torch.device("cpu"))
        total, folded = sharded.sharded_round_step(BN254_FR, mesh, polys, challenge)
        assert mesh.collectives == 1
    finally:
        mesh.close()
    assert not dist.is_initialized()
    assert torch.equal(total, limb.sum_reduce(BN254_FR, sharded.vanilla_gate_eval(BN254_FR, polys)))
    assert torch.equal(folded, ksc.fold(BN254_FR, polys, challenge))


def test_make_mesh_refuses_nccl_on_the_cpu():
    """The backend is the caller's: NCCL on the CPU raises, and no group
    (gloo or other) starts in its place."""
    import torch.distributed as dist

    from plonkish_tpu_torch.parallel import sharded

    with pytest.raises(ValueError, match="NCCL runs on CUDA cards"):
        sharded.make_mesh("nccl", device="cpu")
    assert not dist.is_initialized()


def test_sharded_round_step(ranks):
    """The gate, its exact all-reduced sum and the fold of each rank's block
    against the JAX package's host field arithmetic on the same columns."""
    from plonkish_tpu.fields import BN254_FR as REF_FR
    from plonkish_tpu.fields.host import Fp as RefFp

    world, results = ranks
    n = 1 << K_STEP
    cols = [[RefFp(v, REF_FR) for v in _ints(9 * n, 11)[i * n:(i + 1) * n]] for i in range(9)]
    pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o = cols
    total = RefFp.zero(REF_FR)
    for b in range(n):
        total = total + (q_l[b] * w_l[b] + q_r[b] * w_r[b] + q_m[b] * w_l[b] * w_r[b]
                         + q_o[b] * w_o[b] + q_c[b] + pi[b])
    x = RefFp(CHALLENGE, REF_FR)
    folded = [[int(c[2 * i] + x * (c[2 * i + 1] - c[2 * i])) for i in range(n // 2)] for c in cols]
    size = n // 2 // world
    for r in results:
        got_total, got_folded = r["round_step"]
        assert got_total == int(total)
        rank = r["rank"]
        want = [v for c in folded for v in c[rank * size:(rank + 1) * size]]
        assert got_folded == want


@pytest.mark.parametrize("case", list(MSM_CASES))
def test_sharded_msm(ranks, case):
    """variable_base_msm under the mesh against the JAX package's msm_host;
    n = 64 splits over the ranks (sharded_msm), n = 6 cannot (6 does not
    divide over 4, and 3 points a rank over 2 are fewer than 4), so every
    rank runs the whole MSM, the reference's rule."""
    from plonkish_tpu.curves import host as ref_host
    from plonkish_tpu.curves.specs import BN254_G1 as REF_G1
    from plonkish_tpu.fields.host import Fp as RefFp

    world, results = ranks
    n, bits = MSM_CASES[case]
    pts = _msm_points(ref_host.AffinePoint, REF_G1, n, 300 + n)
    scalars = _ints(n, 400 + bits, 1 << bits if bits < 254 else REF_G1.scalar.p)
    want = ref_host.msm_host([RefFp(s, REF_G1.scalar) for s in scalars], pts)
    for r in results:
        xy, taken = r["msm"][case]
        assert xy == (int(want.x), int(want.y))
        assert taken == (1 if n % world == 0 and n // world >= 4 else 0)


@pytest.mark.parametrize("name", ["vanilla", "rotation"])
def test_sharded_sum_check_transcript(ranks, name):
    """The zero-check of the vanilla PLONK expression (identity and Lagrange
    leaves) and the rotation-bearing expression: every rank's transcript
    equals the JAX package's ClassicSumCheck run unsharded."""
    from plonkish_tpu.fields import BN254_FR as REF_FR
    from plonkish_tpu.fields.host import Fp as RefFp
    from plonkish_tpu.models import circuits as ref_circuits
    from plonkish_tpu.piop import sum_check as ref_sc
    from plonkish_tpu.poly.multilinear import MLPoly as RefMLPoly
    from plonkish_tpu.utils import expression as ref_ex
    from plonkish_tpu.utils.transcript import Keccak256Transcript as RefTranscript

    expr, polys, ch, ys = _sum_check_inputs(name, ref_ex, ref_circuits, RefFp, REF_FR,
                                            RefMLPoly.from_ints)
    tr = RefTranscript(REF_FR)
    ref_sc.ClassicSumCheck.evaluations().prove(
        REF_FR, K_SC, ref_sc.VirtualPolynomial(expr, polys, ch, ys), RefFp.zero(REF_FR), tr)
    want = tr.into_proof()
    _, results = ranks
    for r in results:
        proof, taken = r["sum_check"][name]
        assert taken == 1
        assert proof == want


@pytest.mark.parametrize("pcs", ["kzg", "brakedown"])
def test_sharded_hyperplonk_equals_reference(ranks, reference_proofs, pcs):
    """Every rank's HyperPlonk proof equals the JAX package's unsharded proof
    byte for byte (which its verifier accepted), and the sharded paths were
    taken: the zero-check and batch-open sum-checks, the permutation z polys
    and, over KZG, every commitment MSM.  Brakedown's commit stays whole
    here: its matrix at k = 6 has one row (test_sharded_brakedown_commit)."""
    world, results = ranks
    for r in results:
        proof, taken, collectives, sent = r["hyperplonk"][pcs]
        assert proof == reference_proofs[pcs]
        assert taken["sum_check"] == (2 if pcs == "kzg" else 1)
        assert taken["permutation_z"] == 1
        # the commitments of the 2^6-row polys and the larger opening quotients
        assert taken.get("msm", 0) >= (5 if pcs == "kzg" else 0)
        assert set(taken) <= {"sum_check", "permutation_z", "msm"}
        assert collectives > 0 and sent > 0


def test_sharded_brakedown_commit(ranks):
    """A commit of an 8-row matrix: each rank encodes its rows; the gathered
    codewords, the column hashes and the root equal the JAX package's."""
    from plonkish_tpu.fields import BN254_FR as REF_FR
    from plonkish_tpu.pcs import brakedown as ref_brakedown
    from plonkish_tpu.pcs import brakedown_code as ref_code
    from plonkish_tpu.poly.multilinear import MLPoly as RefMLPoly

    pp = ref_brakedown.BrakedownParams(num_vars=8, num_rows=BRAKEDOWN_ROWS,
                                       code=_brakedown_code(ref_code, REF_FR))
    comm = ref_brakedown.MultilinearBrakedown(REF_FR, ref_code.BRAKEDOWN_SPEC_TEST).commit(
        pp, RefMLPoly.from_ints(REF_FR, _ints(256, 900)))
    _, results = ranks
    for r in results:
        root, rows, hashes, taken = r["brakedown_commit"]
        assert taken == 1
        assert root == comm.root and list(hashes) == list(comm.intermediate_hashes)
        assert np.array_equal(convert.limbs_to_digits(torch.from_numpy(rows)),
                              np.asarray(comm.rows))


def test_entry_runs():
    from plonkish_tpu_torch import graft_entry
    from plonkish_tpu_torch.parallel.sharded import vanilla_gate_eval

    fn, (polys, challenge) = graft_entry.entry("cpu")
    round_sum, folded = fn(polys, challenge)
    assert round_sum.shape == (8,) and folded.shape == (9, 128, 8)
    assert torch.equal(round_sum, limb.sum_reduce(BN254_FR, vanilla_gate_eval(BN254_FR, polys)))


def test_dryrun_multichip_two_ranks():
    from plonkish_tpu_torch import graft_entry

    stats = graft_entry.dryrun_multichip(2, device="cpu", deadline_s=300)
    assert [s["rank"] for s in stats] == [0, 1]
    assert all(s["taken"] == {"sum_check": 2, "msm": 1} and s["collectives"] > 0 for s in stats)


def test_failing_rank_fails_the_group():
    """A rank that raises fails spawn, and the other rank, left waiting in a
    collective, does not hang it: the error holds the failed rank's
    traceback, whichever rank's failure was seen first, well before the
    collective's timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(parallel.RankError, match="rank 1:(.|\n)*rank 1 gives up"):
        parallel.spawn(_one_rank_fails, 2, "gloo", "cpu", threads=1, timeout_s=60,
                       deadline_s=120)
    assert time.monotonic() - t0 < 60


def _one_rank_fails(mesh):
    from plonkish_tpu_torch.parallel import sharded

    if mesh.rank == 1:
        raise RuntimeError("rank 1 gives up")
    sharded.all_gather_cat(mesh, torch.zeros(4, dtype=torch.int64))
