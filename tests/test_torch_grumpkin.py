"""The second curve and field of this slice on the CPU: Grumpkin G1 (base
field BN254 Fr) through the MSM kernels' plain versions and through the g++
twin of csrc/msm.cu, sum-check rounds and folds over BN254 Fq against the
reference's EvaluationsProver on the cpp backend and through the twins of
the generated K3 and of K4, the IPA base fold (its twin against its plain
version, curves/device.py's padd and scalar_mul_const), and limb.scatter_sum
against the reference's.  Exact equality everywhere."""

import ctypes
import random

import numpy as np
import pytest
import torch

from plonkish_tpu.fields import BN254_FQ as REF_FQ, Fp as RefFp
from plonkish_tpu.models import circuits as ref_circuits
from plonkish_tpu.piop import sum_check as ref_sc
from plonkish_tpu.poly.multilinear import MLPoly as RefMLPoly
from plonkish_tpu_torch import convert, kernels
from plonkish_tpu_torch.curves import device as cdev
from plonkish_tpu_torch.curves import msm as tmsm
from plonkish_tpu_torch.curves.host import AffinePoint, msm_host
from plonkish_tpu_torch.curves.specs import BN254_G1, GRUMPKIN_G1, PALLAS
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR, PALLAS_BASE
from plonkish_tpu_torch.kernels import build
from plonkish_tpu_torch.kernels import ipa as kipa
from plonkish_tpu_torch.kernels import msm as kmsm
from plonkish_tpu_torch.kernels import sumcheck as ksc
from plonkish_tpu_torch.kernels import sumcheck_gen
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.piop import sum_check as sc
from plonkish_tpu_torch.poly.multilinear import MLPoly

torch.set_num_threads(1)

C = GRUMPKIN_G1
Q = BN254_FQ.p


@pytest.fixture(scope="module")
def twin():
    try:
        path = build.build_cpu_twin()
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    lib = ctypes.CDLL(str(path))
    build.bind(lib.twin_jac_op, [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
               + [ctypes.c_int64])
    build.bind(lib.twin_msm_bucket_level, kmsm.LEVEL_ARGS)
    build.bind(lib.twin_msm_window_level, kmsm.WINDOW_ARGS)
    build.bind(lib.twin_msm_window_combine, kmsm.COMBINE_ARGS)
    build.bind(lib.twin_sumcheck_fold, ksc.FOLD_ARGS)
    build.bind(lib.twin_ipa_fold_ladder, kipa.LADDER_ARGS)
    build.bind(lib.twin_ipa_fold_affine, kipa.AFFINE_ARGS)
    return lib


def _points(n, seed, curve=C):
    """Random multiples of G with a repeated point, an opposite point and the
    identity among them."""
    rng = random.Random(seed)
    g = AffinePoint.generator(curve)
    pts = [g.scalar_mul(rng.randrange(1, curve.scalar.p)) for _ in range(n)]
    if n >= 4:
        pts[1] = pts[0]
        pts[2] = -pts[0]
        pts[3] = AffinePoint.identity(curve)
    return pts


def test_generator_and_kernels_accept_only_the_ported_curves():
    g = AffinePoint.generator(C)
    assert g.is_on_curve() and g.scalar_mul(Q).is_identity()
    assert kernels.curve_id(BN254_G1) == 0 and kernels.curve_id(C) == 1
    with pytest.raises(NotImplementedError):
        kernels.curve_id(PALLAS)
    assert kernels.field_id(BN254_FR) == 0 and kernels.field_id(BN254_FQ) == 1
    assert [kernels.field_struct(s) for s in (BN254_FR, BN254_FQ)] == ["Fr", "Fq"]
    with pytest.raises(NotImplementedError):
        kernels.field_id(PALLAS_BASE)
    # a tensor on another device than the CPU launches the kernel or raises
    meta = limb.zeros((4, 2)).to("meta")
    with pytest.raises((RuntimeError, ValueError)):
        kipa.base_fold(C, meta, meta, 3)


def _msm_case(n, kind, seed):
    rng = random.Random(seed)
    if kind == "multiples":  # i * G by running sums: the MSM is one multiple of G
        g = AffinePoint.generator(C)
        pts, acc = [], AffinePoint.identity(C)
        for _ in range(n):
            pts.append(acc)
            acc = acc + g
    else:
        pts = _points(n, seed)
    if kind == "identity_points":
        pts = [AffinePoint.identity(C)] * n
    scalars = {"zero": [0] * n, "equal": [rng.randrange(Q)] * n}.get(
        kind, [rng.randrange(Q) for _ in range(n)])
    return pts, scalars


@pytest.mark.parametrize("n,kind", [
    (1, "random"), (32, "random"), (32, "identity_points"), (32, "zero"), (32, "equal"),
    (1024, "multiples"),
])
def test_msm_plain(n, kind):
    """variable_base_msm on Grumpkin through the plain K1 and K2."""
    pts, scalars = _msm_case(n, kind, n)
    bases = cdev.affine_from_host(C, pts, "cpu")
    got = tmsm.variable_base_msm(C, limb.from_ints(scalars), bases)
    if kind == "multiples":  # sum_i s_i * (i G) = (sum_i i s_i) G
        want = AffinePoint.generator(C).scalar_mul(sum(i * v for i, v in enumerate(scalars)) % Q)
    else:
        want = msm_host(scalars, pts)
    assert got == want


@pytest.mark.parametrize("n,kind", [(300, "random"), (200, "equal"), (64, "identity_points")])
def test_msm_kernels_twin(twin, n, kind):
    """K1 and K2 for Grumpkin, built with g++, against the plain versions."""
    pts, scalars = _msm_case(n, kind, 7 + n)
    bases = cdev.affine_from_host(C, pts, "cpu")
    c = tmsm.window_size(n)
    w = tmsm.num_windows(C, c)
    keys, src, nb = tmsm.msm_entries(limb.from_ints(scalars), c, w)
    plain = kmsm.msm_bucket_sums_plain(C, bases, keys, src, w * nb)
    kern = kmsm.bucket_levels(twin.twin_msm_bucket_level, None, bases, keys, src, w * nb, C)
    assert cdev.jac_to_host(C, kern) == cdev.jac_to_host(C, plain)
    buckets = kern.reshape(w, nb, 3, 8)
    got = kmsm.window_levels(twin.twin_msm_window_level, twin.twin_msm_window_combine, None,
                             buckets, c, C)
    assert cdev.jac_to_host(C, got[None]) == cdev.jac_to_host(
        C, kmsm.msm_window_sums_plain(C, buckets, c)[None])
    assert cdev.jac_to_host(C, got[None])[0] == msm_host(scalars, pts)


def test_curve_ops_twin_and_plain(twin):
    """jac_madd, jac_add and jac_dbl over Grumpkin's base field (the twin)
    and the plain padd, pdbl and scalar_mul_const, against the host."""
    n = 8
    ps, qs = _points(n, 3), _points(n, 3)[:4] + _points(n, 4)[4:]
    pj = cdev.affine_to_jac_storage(C, cdev.affine_from_host(C, ps, "cpu"))
    qa = cdev.affine_from_host(C, qs, "cpu")
    qj = cdev.affine_to_jac_storage(C, qa)
    out = torch.empty_like(pj)
    for op, q, want in ((0, qa, [p + q for p, q in zip(ps, qs)]),
                        (1, qj, [p + q for p, q in zip(ps, qs)]),
                        (2, qj, [p + p for p in ps])):
        assert twin.twin_jac_op(kernels.curve_id(C), op, pj.data_ptr(), q.data_ptr(), out.data_ptr(), n) == 0
        assert cdev.jac_to_host(C, out) == want
    assert cdev.jac_to_host(C, cdev.padd(C, pj, qj)) == [p + q for p, q in zip(ps, qs)]
    assert cdev.jac_to_host(C, cdev.pdbl(C, pj)) == [p + p for p in ps]
    assert cdev.jac_to_host(C, cdev.identity(C, (2,))) == [AffinePoint.identity(C)] * 2
    k = random.Random(5).randrange(Q)
    assert cdev.jac_to_host(C, cdev.scalar_mul_const(C, pj, k)) == [p.scalar_mul(k) for p in ps]
    # BN254 G1 too, from affine points (every addition mixed)
    bn = _points(2, 6, BN254_G1)
    k = random.Random(6).randrange(BN254_FR.p)
    got = cdev.scalar_mul_const(BN254_G1, cdev.affine_from_host(BN254_G1, bn, "cpu"), k)
    assert cdev.jac_to_host(BN254_G1, got) == [p.scalar_mul(k) for p in bn]


LAMBDA = cdev._endomorphism(C)[1]


def _xi_with_signs(s1, s2):
    """A random xi whose GLV halves k1, k2 have the signs s1, s2."""
    rng = random.Random(30 + 2 * s1 + s2)
    while True:
        xi = rng.randrange(Q)
        k1, k2 = cdev._glv_split(C, xi)
        if (k1 > 0) - (k1 < 0) == s1 and (k2 > 0) - (k2 < 0) == s2:
            return xi


def _fold_twin(twin, left, right, xi):
    """The fold through the twins of its two kernels, each held against its
    plain version: the ladder's Jacobian points equal the plain ones as
    points, the conversion is exact on the plain ones.  Returns the twins'
    fold and the plain one."""
    jac = kipa.ladder_launch(twin.twin_ipa_fold_ladder, None, C, left, right, xi)
    plain_jac = kipa.ladder_plain(C, left, right, xi)
    plain = kipa.affine_plain(C, plain_jac)
    assert torch.equal(kipa.affine_launch(twin.twin_ipa_fold_affine, None, C, plain_jac), plain)
    return kipa.affine_launch(twin.twin_ipa_fold_affine, None, C, jac), plain


@pytest.mark.parametrize("xi", [
    0, 1, Q - 1, 0x2468ACE13579BDF02468ACE13579BDF0, LAMBDA, Q - LAMBDA,
    _xi_with_signs(1, 1), _xi_with_signs(1, -1), _xi_with_signs(-1, 1),
    _xi_with_signs(-1, -1)],
    ids=["0", "1", "q-1", "random", "lambda", "-lambda", "k1+k2+", "k1+k2-", "k1-k2+",
         "k1-k2-"])
def test_ipa_base_fold_twin(twin, xi):
    """The fold kernels' per-thread bodies against their plain versions and
    the host: identities on both sides, L = R and L = -R among the points;
    xi = lambda (k1 = 0), 1 (k2 = 0) and GLV halves of both signs."""
    n = 6
    left_pts, right_pts = _points(n, 11), _points(n, 12)
    right_pts[4], right_pts[5] = left_pts[4], -left_pts[5]
    left, right = (cdev.affine_from_host(C, p, "cpu") for p in (left_pts, right_pts))
    want = [a + b.scalar_mul(xi) for a, b in zip(left_pts, right_pts)]
    got, plain = _fold_twin(twin, left, right, xi)
    assert cdev.affine_to_host(C, plain) == want
    assert torch.equal(got, plain)
    assert torch.equal(kipa.base_fold(C, left, right, xi), plain)
    with pytest.raises(NotImplementedError):
        kipa.ladder_launch(twin.twin_ipa_fold_ladder, None, BN254_G1, left, right, xi)


def test_ipa_base_fold_twin_across_chunks(twin):
    """One chunk of the batch inversion and 3 points more: the first chunk's
    sums are all the identity (L = -xi R), so its inversion is of one."""
    xi = 0x1D3F5B79E2C4A6081D3F5B79E2C4A608
    n = kipa.FOLD_CHUNK + 3
    rng = random.Random(13)
    g = AffinePoint.generator(C)
    r = [rng.randrange(1, Q) for _ in range(n)]
    right_pts = [g.scalar_mul(v) for v in r]
    left_pts = [g.scalar_mul(-v * xi % Q) if i < kipa.FOLD_CHUNK else
                g.scalar_mul(rng.randrange(1, Q)) for i, v in enumerate(r)]
    left, right = (cdev.affine_from_host(C, p, "cpu") for p in (left_pts, right_pts))
    got, plain = _fold_twin(twin, left, right, xi)
    want = [a + b.scalar_mul(xi) for a, b in zip(left_pts, right_pts)]
    assert all(p.is_identity() for p in want[:kipa.FOLD_CHUNK])
    assert cdev.affine_to_host(C, plain) == want
    assert torch.equal(got, plain)


def _digit_value(code):
    """The digit of `code` as an integer mod the order (w -> lambda)."""
    if not code:
        return 0
    d = next(d for c, d in kipa.digit_table().values() if c == code)
    return (d[0] + d[1] * LAMBDA) % Q


def test_ipa_fold_schedule():
    """xi's digits: their value is xi mod the order, a nonzero digit is
    followed by a zero, and a random xi takes about 126 digits of which
    about 3/7 are nonzero."""
    rng = random.Random(14)
    lengths, nonzero = [], []
    for xi in [0, 1, 2, 11, Q - 1, LAMBDA] + [rng.randrange(Q) for _ in range(40)]:
        codes = kipa.digits(C, xi)
        acc = 0
        for code in codes:
            acc = (2 * acc + _digit_value(code)) % Q
        assert acc == xi % Q
        assert all(not (a and b) for a, b in zip(codes, codes[1:]))
        lengths.append(len(codes))
        nonzero.append(sum(1 for c in codes if c))
    assert kipa.digits(C, 0) == [] and kipa.digits(C, 1) == [kipa.NONZERO]
    assert max(lengths) <= 130 and 120 <= sum(lengths[6:]) / 40 <= 130
    assert 48 <= sum(nonzero[6:]) / 40 <= 60


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % Q for row in words]


@pytest.mark.parametrize("name", ["vanilla_plonk_expression", "vanilla_plonk_with_lookup_expression"])
def test_fq_rounds_match_reference(name):
    """Every round of a zero-check over Fq: the port's plain K3 and K4
    against the reference's EvaluationsProver."""
    num_vars = 4
    expr = getattr(circuits, name)(BN254_FQ, num_vars)
    rexpr = getattr(ref_circuits, name)(REF_FQ, num_vars)
    num_polys = 1 + max(q.poly for q in expr.used_query())
    ref = [RefMLPoly.from_ints(REF_FQ, _ints(1 << num_vars, 30 + i)) for i in range(num_polys)]
    ours = [MLPoly(BN254_FQ, convert.digits_to_limbs(p.evals)) for p in ref]
    ch, y = _ints(3, 1), _ints(num_vars, 2)
    state = sc.ProverState(BN254_FQ, num_vars, Fp.zero(BN254_FQ), sc.VirtualPolynomial(
        expr, ours, [Fp(c, BN254_FQ) for c in ch], [[Fp(v, BN254_FQ) for v in y]]))
    rstate = ref_sc.ProverState(REF_FQ, num_vars, RefFp.zero(REF_FQ), ref_sc.VirtualPolynomial(
        rexpr, ref, [RefFp(c, REF_FQ) for c in ch], [[RefFp(v, REF_FQ) for v in y]]))
    prover, rprover = sc.EvaluationsProver(state), ref_sc.EvaluationsProver(rstate)
    rng = random.Random(3)
    for round_ in range(num_vars):
        assert [int(v) for v in prover.prove_round(state).values] == [
            int(v) for v in rprover.prove_round(rstate).values], f"round {round_}"
        r = rng.randrange(Q)
        state.next_round(Fp(5, BN254_FQ), Fp(r, BN254_FQ))
        rstate.next_round(RefFp(5, REF_FQ), RefFp(r, REF_FQ))
    assert [int(v) for v in state.into_evals()] == [int(v) for v in rstate.into_evals()]


def test_fq_round_and_fold_twins(twin):
    """The generated K3 over Fq and K4 over Fq, built with g++, against the
    plain versions; the generated source names the field."""
    from plonkish_tpu_torch.piop.sum_check import identity_params

    num_vars = 5
    expr = circuits.vanilla_plonk_expression(BN254_FQ, num_vars)
    num_polys = 1 + max(q.poly for q in expr.used_query())
    polys = [MLPoly.from_ints(BN254_FQ, _ints(1 << num_vars, 60 + i), "cpu")
             for i in range(num_polys)]
    state = sc.ProverState(BN254_FQ, num_vars, Fp.zero(BN254_FQ), sc.VirtualPolynomial(
        expr, polys, [Fp(c, BN254_FQ) for c in _ints(3, 61)],
        [[Fp(v, BN254_FQ) for v in _ints(num_vars, 62)]]))
    prover = sc.EvaluationsProver(state)
    tape = (prover.instrs, prover.tape.num_regs, prover.tape.out_reg, state.stacked.shape[0],
            state.degree)
    src_fq = sumcheck_gen.source(*tape, BN254_FQ)
    assert "using F = Fq;" in src_fq and "using F = Fr;" in sumcheck_gen.source(*tape)
    assert sumcheck_gen.structure(*tape, BN254_FQ) != sumcheck_gen.structure(*tape)
    ids = identity_params(BN254_FQ, 0, state.identity_offset, "cpu")
    kern = sumcheck_gen.twin(*tape, spec=BN254_FQ)
    got = ksc.round_launch(kern, None, state.stacked, prover.consts, state.degree, ids)
    want = ksc.sumcheck_round_plain(BN254_FQ, state.stacked, prover.instrs, prover.consts,
                                    prover.tape.num_regs, prover.tape.out_reg, state.degree, ids)
    assert torch.equal(got, want)
    ch = limb.const(BN254_FQ, 0xFEDCBA987654321)
    assert torch.equal(ksc.fold_launch(twin.twin_sumcheck_fold, None, state.stacked, ch, BN254_FQ),
                       ksc.fold_plain(BN254_FQ, state.stacked, ch))


def test_scatter_sum_matches_reference():
    from plonkish_tpu.fields import limb as ref_limb

    rng = random.Random(9)
    cells, m = 60, 9
    vals = [rng.choice([0, 1, Q - 1, rng.randrange(Q)]) for _ in range(2 * cells)]
    idx = [rng.randrange(m) for _ in range(cells)]
    terms = limb.from_canonical_ints(BN254_FQ, vals).reshape(2, cells, 8)
    got = limb.scatter_sum(BN254_FQ, terms, torch.tensor(idx), m)
    ref_terms = ref_limb.to_mont(REF_FQ, ref_limb.from_ints(vals)).reshape(2, cells, ref_limb.L)
    want = ref_limb.scatter_sum(REF_FQ, ref_terms, np.asarray(idx), m)
    assert torch.equal(got, convert.digits_to_limbs(np.asarray(want).reshape(-1, ref_limb.L))
                       .reshape(2, m, 8))
