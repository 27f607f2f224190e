"""Kernels K1-K5 and the Montgomery conversion on a CUDA card against their
plain versions, and a golden proof produced on the card.  Marked ``gpu``:
without a card each test skips (decided inside the test, never at import).
On the card run them with

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
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_round_message_kernel_matches_plain(cuda, field):
    """K6 (csrc/fiat_shamir.cu) against its plain version: degrees 1, 3, 5
    from sponges with 0, 32, 80 and 120 bytes pending, and the Coefficients
    round, as tests/test_torch_fiat_shamir.py holds the g++ twin."""
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES
    from plonkish_tpu_torch.kernels import fiat_shamir as kfs
    from plonkish_tpu_torch.piop import fiat_shamir as fs
    from test_torch_device_fs import k6_round_case

    spec = BN254_FR if field == "fr" else BN254_FQ
    for degree in (1, 3, 5):
        for pending in (0, 32, 80, 120):
            case = {k: v.to(cuda) for k, v in k6_round_case(spec, degree, pending, degree).items()}
            outs = []
            for plain in (False, True):
                b = {k: v.clone() for k, v in case.items()}
                out = torch.zeros((degree + 2, 8), dtype=torch.int32, device=cuda)
                chm = torch.zeros(8, dtype=torch.int32, device=cuda)
                ids = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
                args = (b["sums"], b["scal"], b["sponge"], b["fixed"], b["rows"], out, chm, ids)
                before = LAUNCHES["fs_round_message"]
                (fs.round_message_plain if plain else fs.round_message)(spec, degree, *args)
                assert LAUNCHES["fs_round_message"] == before + (0 if plain else 1)
                outs.append([b["scal"], b["sponge"], out, chm, ids])
            assert all(torch.equal(g, w) for g, w in zip(*outs)), (degree, pending)
    case = {k: v.to(cuda) for k, v in k6_round_case(spec, 3, 80, 7).items()}
    outs = []
    for fn in (kfs.coeff_cuda, fs.coeff_message_plain):
        scal, sponge = case["scal"][0].clone(), case["sponge"].clone()
        out = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
        chm = torch.zeros(8, dtype=torch.int32, device=cuda)
        fn(spec, case["sums"][:2].contiguous(), scal, sponge, case["scal"][1], out, chm)
        outs.append([scal, sponge, out, chm])
    assert all(torch.equal(g, w) for g, w in zip(*outs))


@pytest.mark.gpu
def test_device_fs_zero_check_has_no_host_read(cuda):
    """The device-transcript zero-check at k = 12, its rounds launched one by
    one and fused (K7), enqueues every round under set_sync_debug_mode("error")
    and gives the host loop's challenges."""
    from plonkish_tpu_torch.fields.spec import BN254_FR as S
    from plonkish_tpu_torch.profile_zero_check import device_fs, host_fs, zero_check_polys
    from plonkish_tpu_torch.models.circuits import rand_vanilla_plonk_circuit

    k = 12
    vp = zero_check_polys(S, k, rand_vanilla_plonk_circuit(S, k, random.Random(1),
                                                           random.Random(2)), cuda)
    _, host_ch, host_ev = host_fs(S, k, vp, cuda, lambda line: None)
    _, dev_ch, dev_ev = device_fs(S, k, vp, cuda, lambda line: None, sync_check=True)
    assert dev_ch == host_ch and dev_ev == host_ev
    _, dev_ch, dev_ev = device_fs(S, k, vp, cuda, lambda line: None, sync_check=True,
                                  fused=True)
    assert dev_ch == host_ch and dev_ev == host_ev


@pytest.mark.gpu
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_fused_rounds_kernel_matches_plain(cuda, field):
    """K7 (csrc/sumcheck_fused.cuh) against its plain version: every round of
    the vanilla zero-check at k = 10, from sponges with 0 and 80 bytes
    pending, and the rounds from round 4 on."""
    from plonkish_tpu_torch.fields.host import Fp
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.models import circuits
    from plonkish_tpu_torch.piop import sum_check as sc
    from plonkish_tpu_torch.poly.multilinear import MLPoly
    from plonkish_tpu_torch.utils.transcript import Keccak256Transcript

    spec = BN254_FR if field == "fr" else BN254_FQ
    k, rng = 10, random.Random(4)
    expr = circuits.vanilla_plonk_expression(spec, k)
    polys = [MLPoly.from_ints(spec, [rng.randrange(spec.p) for _ in range(1 << k)], cuda)
             for _ in range(1 + max(q.poly for q in expr.used_query()))]
    vp = sc.VirtualPolynomial(expr, polys, [Fp(rng.randrange(spec.p), spec) for _ in range(3)],
                              [[Fp(rng.randrange(spec.p), spec) for _ in range(k)]])
    order = ("ids", "rows", "sponge", "scal", "fixed", "out", "ch_mont")
    for pending, first in ((0, 0), (80, 4)):
        state = sc.ProverState(spec, k, Fp(rng.randrange(spec.p), spec), vp)
        prover = sc.EvaluationsProver(state)
        tr = Keccak256Transcript(spec)
        tr.state.update(bytes(136 + pending))
        run = sc.DeviceFsRun(state, prover, tr)
        stacked = state.stacked[:, : state.stacked.shape[1] >> first].contiguous()
        t = prover.tape
        outs, launched = [], []
        for fn in (ksc.fused_rounds_cuda, ksc.fused_rounds_plain):
            b = {n: getattr(run, n).clone() for n in order}
            before = LAUNCHES["sumcheck_fused"]
            final = fn(spec, stacked.clone(), prover.instrs, prover.consts, t.num_regs,
                       t.out_reg, state.degree, *(b[n] for n in order), first, k - first)
            launched.append(LAUNCHES["sumcheck_fused"] - before)
            outs.append([final] + [b[n] for n in order])
        assert launched == [1, 0]
        assert all(torch.equal(g, w) for g, w in zip(*outs)), (pending, first)


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
    # the zero-check is one launch of K7 (the fused rounds), the batch open's
    # rounds K4 and K6's Coefficients round
    prover_kernels = ("msm_bucket_sums", "msm_window_sums", "sumcheck_fold", "fs_coeff_message",
                      "sumcheck_fused")
    assert all(LAUNCHES[name] > 0 for name in prover_kernels), LAUNCHES
    assert LAUNCHES["sumcheck_fused"] == 1, LAUNCHES
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
@pytest.mark.parametrize("n", [512, (1 << 12) + 3])
@pytest.mark.parametrize("xi", [0, 1, -1, 0x123456789ABCDEF0123456789ABCDEF])
def test_ipa_base_fold_matches_plain(cuda, xi, n):
    """The fold's two kernels against their plain versions: the whole fold
    exactly, and the conversion on the plain ladder's points."""
    from plonkish_tpu_torch.curves import msm as tmsm
    from plonkish_tpu_torch.curves.host import AffinePoint
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1 as C
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.kernels import ipa as kipa

    rng = random.Random(8)
    s = [rng.randrange(C.scalar.p) for _ in range(2 * n)]
    pts = tmsm.fixed_base_msm(C, AffinePoint.generator(C), limb.from_canonical_ints(C.scalar, s, cuda))
    pts[3:5] = 0
    left, right = pts[:n].contiguous(), pts[n:].contiguous()
    right[7] = left[7]
    xi %= C.scalar.p
    plain_jac = kipa.ladder_plain(C, left, right, xi)
    want = kipa.affine_plain(C, plain_jac)
    assert torch.equal(kipa.base_fold_cuda(C, left, right, xi), want)
    assert torch.equal(kipa.affine_cuda(C, plain_jac), want)


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


def _rand_limbs(spec, n, gen, device):
    """n random values below p as int32[n, 8], with 0, 1, p - 1, R mod p and
    R^2 mod p first."""
    from plonkish_tpu_torch.fields import limb

    x = torch.randint(-(1 << 31), 1 << 31, (n, 8), dtype=torch.int32, generator=gen, device=device)
    x[:, 7] = torch.randint(0, spec.p >> 224, (n,), dtype=torch.int32, generator=gen, device=device)
    edge = [0, 1, spec.p - 1, spec.r_mod_p, spec.r2_mod_p]
    x[: len(edge)] = limb.from_ints(edge, device)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_field_convert_kernel_matches_plain(cuda, field):
    """limb.from_mont and limb.to_mont at 2^20 on the card: one launch each of
    csrc/convert.cu, equal to the plain product by the constant (1 or R^2)."""
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES

    spec = {"fr": BN254_FR, "fq": BN254_FQ}[field]
    x = _rand_limbs(spec, 1 << 20, torch.Generator(device=cuda).manual_seed(12), cuda)
    for convert, k in ((limb.from_mont, 1), (limb.to_mont, spec.r2_mod_p)):
        before = LAUNCHES["field_convert"]
        got = convert(spec, x)
        assert LAUNCHES["field_convert"] == before + 1
        assert torch.equal(got, limb.mont_mul(spec, x, limb.from_ints([k], cuda)[0]))
    view = x[:4096].reshape(64, 64, 8).transpose(0, 1)
    assert torch.equal(limb.to_mont(spec, limb.from_mont(spec, view)), view)


@pytest.mark.gpu
def test_commit_launches_the_conversion_once(cuda):
    from plonkish_tpu_torch.curves.msm import variable_base_msm
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import LAUNCHES
    from plonkish_tpu_torch.pcs.kzg import MultilinearKzg
    from plonkish_tpu_torch.poly.multilinear import MLPoly

    k = 10
    pcs = MultilinearKzg(device=cuda)
    pp, _ = pcs.trim(pcs.setup(1 << k, 1, random.Random(0)), 1 << k, 1)
    evals = _rand_limbs(BN254_FR, 1 << k, torch.Generator(device=cuda).manual_seed(13), cuda)
    before = LAUNCHES["field_convert"]
    got = pcs.commit(pp, MLPoly(BN254_FR, evals))
    assert LAUNCHES["field_convert"] == before + 1
    plain = limb.mont_mul(BN254_FR, evals, limb.from_ints([1], cuda)[0])
    assert got == variable_base_msm(pcs.curve, plain, pp.eq(k))


@pytest.mark.gpu
def test_other_fields_keep_the_plain_conversion_on_the_card(cuda):
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BLS12_381_FR, PALLAS_BASE
    from plonkish_tpu_torch.kernels import LAUNCHES

    rng = random.Random(14)
    for spec in (BLS12_381_FR, PALLAS_BASE):
        vals = [0, 1, spec.p - 1] + [rng.randrange(spec.p) for _ in range(61)]
        x = limb.from_ints(vals, cuda)
        before = LAUNCHES["field_convert"]
        assert limb.to_ints(limb.to_mont(spec, x)) == [spec.to_mont(v) for v in vals]
        assert limb.to_ints(limb.from_mont(spec, x)) == [spec.from_mont(v) for v in vals]
        assert LAUNCHES["field_convert"] == before
