"""Kernels K1-K5 on a CUDA card against their plain versions, and a golden
proof produced on the card.  Marked ``gpu``: without a card each test skips
(decided inside the test, never at import).  On the card run them with

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which the card's
machine does not have).  chip_smoke.py runs the same checks at larger sizes.
"""

import pathlib
import random

import pytest
import torch

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _affine(curve, jac):
    from plonkish_tpu_torch.curves import device as cdev

    return cdev.jac_to_affine(curve, cdev.unpack_jac(jac))


@pytest.mark.gpu
def test_msm_kernels_match_plain(cuda):
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.specs import BN254_G1 as C
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.kernels import msm as kmsm

    rng = random.Random(5)
    n = 1000
    s = [rng.randrange(C.scalar.p) for _ in range(n)]
    bases = tmsm.fixed_base_msm(C, AffinePoint.generator(C), limb.from_canonical_ints(C.scalar, s, cuda))
    bases[1] = bases[0]
    bases[2:6] = 0
    scalars = limb.from_ints([rng.randrange(C.scalar.p) for _ in range(n)], cuda)
    scalars[6:20] = 0
    c = tmsm.window_size(n)
    w = tmsm.num_windows(C, c)
    keys, src, nb = tmsm.msm_entries(scalars, c, w)
    k1 = kmsm.msm_bucket_sums_cuda(C, bases, keys, src, w * nb)
    assert torch.equal(_affine(C, k1), _affine(C, kmsm.msm_bucket_sums_plain(C, bases, keys, src, w * nb)))
    buckets = k1.reshape(w, nb, 3, 8)
    k2 = kmsm.msm_window_sums_cuda(C, buckets, c)
    assert torch.equal(_affine(C, k2[None]), _affine(C, kmsm.msm_window_sums_plain(C, buckets, c)[None]))


@pytest.mark.gpu
def test_sumcheck_kernels_match_plain(cuda):
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FR as S
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.models.circuits import vanilla_plonk_expression
    from plonkish_tpu_torch.piop import sum_check as sc
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    rng = random.Random(6)
    k = 10
    expr = vanilla_plonk_expression(S, k)
    polys = [MLPoly.from_ints(S, [rng.randrange(S.p) for _ in range(1 << k)], cuda) for _ in range(13)]
    vp = sc.VirtualPolynomial(expr, polys, [Fp(rng.randrange(S.p), S) for _ in range(3)],
                              [[Fp(rng.randrange(S.p), S) for _ in range(k)]])
    state = sc.ProverState(S, k, Fp.zero(S), vp)
    prover = sc.EvaluationsProver(state)
    ids = sc.identity_params(S, 0, state.identity_offset, cuda)
    args = (state.stacked, prover.instrs, prover.consts, prover.tape.num_regs,
            prover.tape.out_reg, state.degree, ids)
    assert torch.equal(ksc.sumcheck_round_cuda(S, *args), ksc.sumcheck_round_plain(S, *args))
    ch = limb.const(S, 99, cuda)
    assert torch.equal(ksc.fold_cuda(S, state.stacked, ch), ksc.fold_plain(S, state.stacked, ch))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 16, 100, 4096])
@pytest.mark.parametrize("kind", ["vanilla_like", "single_leaf", "lookup", "beyond_limits"])
def test_generated_round_kernel_matches_plain(cuda, kind, s):
    """K3 generated for each expression of tests/test_torch_csrc_cpu.py
    (the lookup zero-check and a tape beyond a fixed 32-register file among
    them), on the card against the plain version."""
    from plonkish_tpu_torch.fields.spec import BN254_FR as S
    from plonkish_tpu_torch.kernels import LAUNCHES
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from test_torch_csrc_cpu import round_case

    args = round_case(kind, s, cuda)
    before = LAUNCHES["sumcheck_round"]
    got = ksc.sumcheck_round_cuda(S, *args)
    assert LAUNCHES["sumcheck_round"] == before + 1
    assert torch.equal(got, ksc.sumcheck_round_plain(S, *args))


@pytest.mark.gpu
def test_probe_kernel_matches_plain(cuda):
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES, probe

    for spec in (BN254_FR, BN254_FQ):
        rng = random.Random(8)
        r = (1 << 256) % spec.p
        xs = [0, 1, spec.p - 1, r, r * r % spec.p, ((1 << 255) - 19) % spec.p]
        xs += [rng.randrange(spec.p) for _ in range(1000 - len(xs))]
        ys = [rng.randrange(spec.p) for _ in range(1000)]
        ys[6:8] = xs[6:8]
        a, b = limb.from_ints(xs, cuda), limb.from_ints(ys, cuda)
        want = probe.mont_mul_chain_plain(spec, a, b, 16, "u32")
        before = LAUNCHES["mont_mul_chain"]
        for variant in probe.VARIANTS:
            for per_thread in probe.PER_THREAD:
                got = probe.mont_mul_chain(spec, a, b, 16, variant, per_thread, 128)
                assert torch.equal(got, want), (spec, variant, per_thread)
        assert LAUNCHES["mont_mul_chain"] == before + 6


@pytest.mark.gpu
def test_golden_k3_on_the_card(cuda):
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES, reset_launches
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(1), random.Random(2))
    backend = HyperPlonk(MultilinearKzg())
    pp, vp = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    reset_launches()
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, circuit, tr)
    prover_kernels = ("msm_bucket_sums", "msm_window_sums", "sumcheck_round", "sumcheck_fold")
    assert all(LAUNCHES[name] > 0 for name in prover_kernels), LAUNCHES
    proof = tr.into_proof()
    assert proof == (GOLDEN / "hyperplonk_kzg_k3.bin").read_bytes()
    backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, proof))


@pytest.mark.gpu
def test_grumpkin_msm_kernels_match_plain(cuda):
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1 as C
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.kernels import msm as kmsm

    rng = random.Random(6)
    n = 1000
    s = [rng.randrange(C.scalar.p) for _ in range(n)]
    bases = tmsm.fixed_base_msm(C, AffinePoint.generator(C), limb.from_canonical_ints(C.scalar, s, cuda))
    bases[1] = bases[0]
    bases[2:4] = 0
    scalars = limb.from_ints([rng.randrange(C.scalar.p) for _ in range(n)], cuda)
    c = tmsm.window_size(n)
    w = tmsm.num_windows(C, c)
    keys, src, nb = tmsm.msm_entries(scalars, c, w)
    k1 = kmsm.msm_bucket_sums_cuda(C, bases, keys, src, w * nb)
    assert torch.equal(_affine(C, k1), _affine(C, kmsm.msm_bucket_sums_plain(C, bases, keys, src, w * nb)))
    buckets = k1.reshape(w, nb, 3, 8)
    k2 = kmsm.msm_window_sums_cuda(C, buckets, c)
    assert torch.equal(_affine(C, k2[None]), _affine(C, kmsm.msm_window_sums_plain(C, buckets, c)[None]))


@pytest.mark.gpu
def test_fq_sumcheck_kernels_match_plain(cuda):
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FQ as F
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.models import circuits
    from plonkish_tpu_torch.piop import sum_check as sc
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    rng = random.Random(7)
    num_vars = 6
    expr = circuits.vanilla_plonk_expression(F, num_vars)
    polys = [MLPoly.from_ints(F, [rng.randrange(F.p) for _ in range(1 << num_vars)], cuda)
             for _ in range(1 + max(q.poly for q in expr.used_query()))]
    state = sc.ProverState(F, num_vars, Fp.zero(F), sc.VirtualPolynomial(
        expr, polys, [Fp(rng.randrange(F.p), F) for _ in range(3)],
        [[Fp(rng.randrange(F.p), F) for _ in range(num_vars)]]))
    prover = sc.EvaluationsProver(state)
    ids = sc.identity_params(F, 0, state.identity_offset, cuda)
    args = (state.stacked, prover.instrs, prover.consts, prover.tape.num_regs,
            prover.tape.out_reg, state.degree, ids)
    assert torch.equal(ksc.sumcheck_round_cuda(F, *args), ksc.sumcheck_round_plain(F, *args))
    ch = limb.const(F, 987654321, cuda)
    assert torch.equal(ksc.fold_cuda(F, state.stacked, ch), ksc.fold_plain(F, state.stacked, ch))


@pytest.mark.gpu
@pytest.mark.parametrize("xi", [0, 1, -1, 0x123456789ABCDEF0123456789ABCDEF])
def test_ipa_base_fold_matches_plain(cuda, xi):
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1 as C
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.kernels import ipa as kipa

    rng = random.Random(8)
    n = 512
    s = [rng.randrange(C.scalar.p) for _ in range(2 * n)]
    pts = tmsm.fixed_base_msm(C, AffinePoint.generator(C), limb.from_canonical_ints(C.scalar, s, cuda))
    pts[3:5] = 0
    left, right = pts[:n].contiguous(), pts[n:].contiguous()
    right[7] = left[7]
    xi %= C.scalar.p
    assert torch.equal(kipa.base_fold_cuda(C, left, right, xi),
                       kipa.base_fold_plain(C, left, right, xi))


@pytest.mark.gpu
def test_golden_protostar_decider_k3_on_the_card(cuda):
    """Two Protostar folds and the decider at k = 3 on the card (as
    tests/test_golden_proofs.py builds the fixture): the proof is
    tests/golden/protostar_kzg_decider_k3.bin and K1-K4 each launched."""
    from plonkish_tpu_torch.accumulation.protostar import Protostar
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES, reset_launches
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    def make(seed):
        return rand_vanilla_plonk_circuit(BN254_FR, 3, random.Random(42), random.Random(seed))

    ci, _ = make(0)
    circuits = [make(100 + i)[1] for i in range(3)]
    scheme = Protostar(MultilinearKzg())
    pp, vp = scheme.preprocess(scheme.setup(ci, random.Random(0)), ci)
    acc = scheme.init_accumulator(pp)
    assert acc.e_poly.device.type == "cuda"
    reset_launches()
    for circuit in circuits[:2]:
        scheme.prove_accumulation_from_nark(pp, acc, circuit, Keccak256Transcript(BN254_FR))
    before = acc.instance.clone()
    tr = Keccak256Transcript(BN254_FR)
    scheme.prove_decider_with_last_nark(pp, acc, circuits[2], tr)
    prover_kernels = ("msm_bucket_sums", "msm_window_sums", "sumcheck_round", "sumcheck_fold")
    assert all(LAUNCHES[name] > 0 for name in prover_kernels), LAUNCHES
    proof = tr.into_proof()
    assert proof == (GOLDEN / "protostar_kzg_decider_k3.bin").read_bytes()
    scheme.verify_decider_with_last_nark(vp, before, circuits[2].instances(),
                                         Keccak256Transcript.from_proof(BN254_FR, proof))


@pytest.mark.gpu
@pytest.mark.parametrize("system,circuit,field", [
    ("protostar", "vanilla", "fr"), ("protostar", "lookup", "fr"),
    ("sangria", "vanilla", "fr"), ("sangria", "lookup", "fr"), ("protostar", "vanilla", "fq"),
])
def test_decider_round_kernels_match_plain(cuda, system, circuit, field):
    """K3 over the decider's expression of each folding scheme, on random
    tables at 2^7 pairs, against its plain version."""
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.piop import sum_check as sc
    from test_torch_protostar import decider_state

    spec = BN254_FR if field == "fr" else BN254_FQ
    state, prover = decider_state(spec, system, circuit, 8, cuda, 9)
    ids = sc.identity_params(spec, 0, state.identity_offset, cuda)
    args = (state.stacked, prover.instrs, prover.consts, prover.tape.num_regs,
            prover.tape.out_reg, state.degree, ids)
    assert torch.equal(ksc.sumcheck_round_cuda(spec, *args), ksc.sumcheck_round_plain(spec, *args))


def _both_devices(prove):
    """prove(device) on the CPU and on the card: (cpu proof, card proof)."""
    return prove(torch.device("cpu")), prove(torch.device("cuda"))


@pytest.mark.gpu
def test_univariate_plonk_k5_on_the_card(cuda):
    """Univariate PLONK at k = 5 on the card gives the CPU's proof bytes; K1
    and K2 launch, K3 and K4 do not."""
    from plonkish_tpu_torch.backend.univariate import UnivariatePlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES, reset_launches
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.univariate_kzg import UnivariateKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    def prove(device):
        info, circuit = rand_vanilla_plonk_circuit(BN254_FR, 5, random.Random(47), random.Random(4247))
        backend = UnivariatePlonk(UnivariateKzg(device=device))
        pp, vp = backend.preprocess(backend.setup(info, random.Random(0)), info)
        reset_launches()
        tr = Keccak256Transcript(BN254_FR)
        backend.prove(pp, circuit, tr)
        proof = tr.into_proof()
        backend.verify(vp, circuit.instances(), Keccak256Transcript.from_proof(BN254_FR, proof))
        return proof, dict(LAUNCHES)

    (cpu, _), (card, launches) = _both_devices(prove)
    assert card == cpu
    assert launches["msm_bucket_sums"] > 0 and launches["msm_window_sums"] > 0, launches
    assert launches["sumcheck_round"] == 0 and launches["sumcheck_fold"] == 0, launches


@pytest.mark.gpu
@pytest.mark.parametrize("circuit", ["aggregation", "sha256"])
def test_benchmark_circuit_proof_on_the_card(cuda, circuit):
    """HyperPlonk + KZG on the aggregation ladder at k = 5 and on one sha256
    block (k = 8) on the card gives the CPU's proof bytes, through K1-K4."""
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES, reset_launches
    from plonkish_tpu_torch.models.aggregation import rand_aggregation_circuit
    from plonkish_tpu_torch.models.sha256 import sha256_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    def prove(device):
        if circuit == "aggregation":
            info, c = rand_aggregation_circuit(BN254_FR, 5, random.Random(1), random.Random(2))
        else:
            info, c, _ = sha256_circuit(b"abc")
        backend = HyperPlonk(MultilinearKzg(device=device))
        pp, vp = backend.preprocess(backend.setup(info, random.Random(7)), info)
        reset_launches()
        tr = Keccak256Transcript(BN254_FR)
        backend.prove(pp, c, tr)
        proof = tr.into_proof()
        backend.verify(vp, c.instances(), Keccak256Transcript.from_proof(BN254_FR, proof))
        return proof, dict(LAUNCHES)

    (cpu, _), (card, launches) = _both_devices(prove)
    assert card == cpu
    prover_kernels = ("msm_bucket_sums", "msm_window_sums", "sumcheck_round", "sumcheck_fold")
    assert all(launches[name] > 0 for name in prover_kernels), launches


@pytest.mark.gpu
@pytest.mark.parametrize("circuit", ["aggregation", "sha256"])
def test_benchmark_circuit_round_kernels_match_plain(cuda, circuit):
    """K3 over the zero-check tapes of the aggregation and sha256 circuits,
    on random tables at 2^7 pairs and at one pair, against its plain version."""
    from plonkish_tpu_torch.backend.hyperplonk.preprocessor import compose
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.models.aggregation import rand_aggregation_circuit
    from plonkish_tpu_torch.models.sha256 import sha256_circuit
    from plonkish_tpu_torch.piop import sum_check as sc
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    spec = BN254_FR
    if circuit == "aggregation":
        info, _ = rand_aggregation_circuit(spec, 4, random.Random(1), random.Random(2))
    else:
        info, _, _ = sha256_circuit(b"abc")
    expr = compose(info)[1]
    rng = random.Random(12)
    num_vars = 8
    polys = [MLPoly.from_ints(spec, [rng.randrange(spec.p) for _ in range(1 << num_vars)], cuda)
             for _ in range(1 + max(q.poly for q in expr.used_query()))]
    vp = sc.VirtualPolynomial(expr, polys, [Fp(rng.randrange(spec.p), spec) for _ in range(3)],
                              [[Fp(rng.randrange(spec.p), spec) for _ in range(num_vars)]])
    state = sc.ProverState(spec, num_vars, Fp.zero(spec), vp)
    prover = sc.EvaluationsProver(state)
    ids = sc.identity_params(spec, 0, state.identity_offset, cuda)
    for part in (state.stacked, state.stacked[:, :2].contiguous()):
        args = (part, prover.instrs, prover.consts, prover.tape.num_regs,
                prover.tape.out_reg, state.degree, ids)
        assert torch.equal(ksc.sumcheck_round_cuda(spec, *args), ksc.sumcheck_round_plain(spec, *args))


def _sharded_prove_rank(mesh, k):
    """One rank of test_two_ranks_share_the_card: the proof, the kernel
    launches and the sharded sites of its prove."""
    from plonkish_tpu_torch.backend.hyperplonk import HyperPlonk
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES, reset_launches
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    ci, circuit = rand_vanilla_plonk_circuit(BN254_FR, k, random.Random(1), random.Random(2))
    backend = HyperPlonk(MultilinearKzg(device=mesh.device))
    pp, _ = backend.preprocess(backend.setup(ci, random.Random(0)), ci)
    mesh.reset_stats()
    reset_launches()
    tr = Keccak256Transcript(BN254_FR)
    backend.prove(pp, circuit, tr)
    return tr.into_proof(), dict(LAUNCHES), dict(mesh.taken)


@pytest.mark.gpu
def test_two_ranks_share_the_card(cuda):
    """Two gloo ranks on one card prove a k = 10 vanilla circuit over KZG:
    each rank's proof equals the unsharded proof on the card, and each rank
    launched K1-K4 on its rows, through sharded_msm."""
    from plonkish_tpu_torch import parallel

    k = 10
    with parallel.use_mesh(None):
        want = _sharded_prove_rank(
            parallel.Mesh(group=None, rank=0, world=1, backend="gloo", device=cuda), k)[0]
    results = parallel.spawn(_sharded_prove_rank, 2, "gloo", cuda, args=(k,), deadline_s=600)
    prover_kernels = ("msm_bucket_sums", "msm_window_sums", "sumcheck_round", "sumcheck_fold")
    for proof, launches, taken in results:
        assert proof == want
        assert all(launches[name] > 0 for name in prover_kernels), launches
        assert taken["msm"] > 0 and taken["sum_check"] == 2 and taken["permutation_z"] == 1
