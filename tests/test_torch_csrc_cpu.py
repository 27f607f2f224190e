"""The CUDA sources' arithmetic and kernel bodies, built for the host with g++
(csrc/cpu_twin.cpp), against the port's plain torch versions.

This gives the kernels' code tier-1 coverage before a card runs it: the
field and curve headers, every per-thread body and shared-memory step of
K1, K2 and K4 (a block's threads run one after another between the
barriers), K3's source as kernels/sumcheck_gen.py generates it for each
expression (its blocks and lanes one after another), and the launch logic of
the wrappers (K1's levels and carries, K2's levels and combine, K3's grid),
which the tests drive through the twins' entry points with CPU tensors.
"""

import ctypes
import random

import pytest
import torch

from plonkish_tpu_torch import kernels
from plonkish_tpu_torch.curves import device as cdev
from plonkish_tpu_torch.curves import msm as tmsm
from plonkish_tpu_torch.curves.host import AffinePoint, msm_host
from plonkish_tpu_torch.curves.specs import BN254_G1
from plonkish_tpu_torch.fields import limb
from plonkish_tpu_torch.fields.host import Fp
from plonkish_tpu_torch.fields.spec import BN254_FQ, BN254_FR
from plonkish_tpu_torch.kernels import build
from plonkish_tpu_torch.kernels import msm as kmsm
from plonkish_tpu_torch.kernels import sumcheck as ksc
from plonkish_tpu_torch.kernels import sumcheck_gen
from plonkish_tpu_torch.models import circuits
from plonkish_tpu_torch.piop import sum_check as sc
from plonkish_tpu_torch.piop.sum_check import identity_params
from plonkish_tpu_torch.piop.tape import compile_tape
from plonkish_tpu_torch.poly.multilinear import MLPoly
from plonkish_tpu_torch.utils import expression as ex
from plonkish_tpu_torch.utils.expression import Query, Rotation

# Tensors here are tiny: one intra-op thread is faster, and keeps parallel
# test workers from oversubscribing the cores.
torch.set_num_threads(1)

C = BN254_G1


@pytest.fixture(scope="module")
def twin():
    try:
        path = build.build_cpu_twin()
    except FileNotFoundError as e:
        pytest.skip(f"no host C++ compiler: {e}")
    lib = ctypes.CDLL(str(path))
    lib.twin_fe_op.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
    build.bind(lib.twin_jac_op, [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
               + [ctypes.c_int64])
    kmsm.check_layout(lib)
    build.bind(lib.twin_msm_bucket_level, kmsm.LEVEL_ARGS)
    build.bind(lib.twin_msm_window_level, kmsm.WINDOW_ARGS)
    build.bind(lib.twin_msm_window_combine, kmsm.COMBINE_ARGS)
    build.bind(lib.twin_sumcheck_fold, ksc.FOLD_ARGS)
    return lib


def _values(spec, n, seed):
    rng = random.Random(seed)
    edge = [0, 1, spec.p - 1, spec.p - 2]
    return edge + [rng.randrange(spec.p) for _ in range(n - len(edge))]


@pytest.mark.parametrize("field", [0, 1])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg"])
def test_field_ops(twin, field, op):
    spec = (BN254_FR, BN254_FQ)[field]
    xs, ys = _values(spec, 64, 1), _values(spec, 64, 2)[::-1]
    a = limb.from_canonical_ints(spec, xs)
    b = limb.from_canonical_ints(spec, ys)
    out = torch.empty_like(a)
    code = ["add", "sub", "mul", "neg"].index(op)
    twin.twin_fe_op(field, code, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0])
    plain = {"add": limb.add, "sub": limb.sub, "mul": limb.mont_mul}.get(op)
    want = limb.neg(spec, a) if op == "neg" else plain(spec, a, b)
    assert torch.equal(out, want)


def _points(n, seed):
    rng = random.Random(seed)
    g = AffinePoint.generator(C)
    pts = [g.scalar_mul(rng.randrange(1, C.scalar.p)) for _ in range(n)]
    pts[1] = pts[0]  # repeated point -> doubling
    pts[2] = -pts[0]  # opposite point -> identity
    pts[3] = AffinePoint.identity(C)
    return pts


def _jac(pts):
    """Host points as Jacobian storage with non-trivial Z (z = 2)."""
    aff = cdev.affine_from_host(C, pts, "cpu")
    x, y, inf = cdev.unpack_affine(aff)
    c = limb._consts(BN254_FQ, "cpu")
    two = limb.d_const(BN254_FQ, 2, "cpu")
    z = torch.where(inf, torch.zeros_like(x), two.expand_as(x))
    z2 = limb.d_mul(z, z, c)
    return cdev.pack_jac((limb.d_mul(x, z2, c), limb.d_mul(y, limb.d_mul(z2, z, c), c), z))


def test_curve_ops(twin):
    n = 12
    ps, qs = _points(n, 3), _points(n, 3)
    qs = qs[:4] + _points(n, 4)[4:]  # 0: P+P, 1: P+P, 2: P+(-P), 3: P+O, rest random
    pj, qj = _jac(ps), _jac(qs)
    qa = cdev.affine_from_host(C, qs, "cpu")
    out = torch.empty_like(pj)
    bn254 = kernels.curve_id(C)
    assert twin.twin_jac_op(bn254, 0, pj.data_ptr(), qa.data_ptr(), out.data_ptr(), n) == 0
    assert cdev.jac_to_host(C, out) == [p + q for p, q in zip(ps, qs)]
    assert twin.twin_jac_op(bn254, 1, pj.data_ptr(), qj.data_ptr(), out.data_ptr(), n) == 0
    assert cdev.jac_to_host(C, out) == [p + q for p, q in zip(ps, qs)]
    assert twin.twin_jac_op(bn254, 1, qj.data_ptr(), pj.data_ptr(), out.data_ptr(), n) == 0
    assert cdev.jac_to_host(C, out) == [q + p for p, q in zip(ps, qs)]
    assert twin.twin_jac_op(bn254, 2, pj.data_ptr(), pj.data_ptr(), out.data_ptr(), n) == 0
    assert cdev.jac_to_host(C, out) == [p + p for p in ps]
    # the plain torch formulas agree on the same inputs
    x, y, inf = cdev.unpack_affine(qa)
    plain = cdev.pack_jac(cdev.jmadd(C, cdev.unpack_jac(pj), x, y, inf))
    assert cdev.jac_to_host(C, plain) == [p + q for p, q in zip(ps, qs)]


def _msm_inputs(n, seed, kind):
    rng = random.Random(seed)
    p = C.scalar.p
    if kind in ("random", "selector"):
        pts = _points(n, seed)
    else:  # many points: multiples i * G by running sums on the host
        g = AffinePoint.generator(C)
        pts, acc = [], g
        for _ in range(n):
            pts.append(acc)
            acc = acc + g
        pts[1], pts[2], pts[3] = pts[0], -pts[0], AffinePoint.identity(C)
    if kind == "selector":  # long runs in few buckets
        scalars = [rng.choice([0, 1, 2, p - 1]) for _ in range(n)]
    elif kind == "one_bucket":  # every entry in bucket 1 of window 0
        scalars = [1] * n
    elif kind == "equal":  # one bucket per window, n entries each
        scalars = [rng.randrange(p)] * n
    elif kind == "zero":
        scalars = [0] * n
    else:
        scalars = [rng.randrange(p) for _ in range(n)]
    if kind == "identity_points":
        pts = [AffinePoint.identity(C)] * n
    if kind in ("random", "selector"):
        scalars[0] = 0
    return pts, scalars


def _twin_msm(twin, pts, scalars):
    """K1 and K2 through the twin and through the plain versions -> the
    MSM as a host point (after checking that the two agree)."""
    n = len(pts)
    bases = cdev.affine_from_host(C, pts, "cpu")
    c = tmsm.window_size(n)
    w = tmsm.num_windows(C, c)
    keys, src, nb = tmsm.msm_entries(limb.from_ints(scalars), c, w)
    plain = kmsm.msm_bucket_sums_plain(C, bases, keys, src, w * nb)
    kern = kmsm.bucket_levels(twin.twin_msm_bucket_level, None, bases, keys, src, w * nb)
    assert cdev.jac_to_host(C, kern) == cdev.jac_to_host(C, plain)
    buckets = kern.reshape(w, nb, 3, 8)
    wplain = kmsm.msm_window_sums_plain(C, buckets, c)
    wkern = kmsm.window_levels(twin.twin_msm_window_level, twin.twin_msm_window_combine,
                               None, buckets, c)
    got = cdev.jac_to_host(C, wkern[None])[0]
    assert got == cdev.jac_to_host(C, wplain[None])[0]
    return got, len(kmsm.bucket_level_sizes(keys.numel()))


@pytest.mark.parametrize("n,kind", [
    pytest.param(40, "random", id="40-False"),
    pytest.param(300, "selector", id="300-True"),
    pytest.param(4096, "one_bucket", id="4096-one_bucket"),
    pytest.param(200, "equal", id="200-equal"),
    pytest.param(200, "zero", id="200-zero"),
    pytest.param(64, "identity_points", id="64-identity_points"),
])
def test_msm_kernels_twin(twin, n, kind):
    pts, scalars = _msm_inputs(n, 5 + n, kind)
    got, levels = _twin_msm(twin, pts, scalars)
    assert levels >= 2  # the carries between tiles are exercised
    if kind == "one_bucket":
        want = AffinePoint.identity(C)
        for p in pts:
            want = want + p
    elif kind == "equal":
        want = AffinePoint.identity(C)
        for p in pts:
            want = want + p
        want = want.scalar_mul(scalars[0])
    else:
        want = msm_host(scalars, pts)
    assert got == want
    if kind in ("zero", "identity_points"):
        assert got.is_identity()


@pytest.mark.parametrize("windows,c", [(17, 16), (20, 14), (128, 2)])
def test_msm_window_combine_twin(twin, windows, c):
    rng = random.Random(windows)
    g = AffinePoint.generator(C)
    sums = [g.scalar_mul(rng.randrange(1, C.scalar.p)) for _ in range(windows)]
    sums[1] = AffinePoint.identity(C)
    sums[2] = sums[0]
    jac = _jac(sums)
    pv = torch.stack([torch.zeros_like(jac), jac], 1).reshape(windows, 1, 2, 3, 8).contiguous()
    out = torch.empty((3, 8), dtype=torch.int32)
    assert twin.twin_msm_window_combine(pv.data_ptr(), windows, c, out.data_ptr(),
                                       kernels.curve_id(C), None) == 0
    want = AffinePoint.identity(C)
    for s in reversed(sums):
        for _ in range(c):
            want = want.double()
        want = want + s
    assert cdev.jac_to_host(C, out[None])[0] == want
    plain = kmsm.msm_window_combine_plain(C, jac, c)
    assert cdev.jac_to_host(C, plain[None])[0] == want


def test_msm_layout_is_checked(twin):
    kmsm.check_layout(twin)
    fn = build.bind(twin.msm_check_layout, [ctypes.c_int] * 3)
    assert fn(kmsm.K1_TILE, kmsm.K2_SEGMENT, kmsm.K2_THREADS) == 0
    assert fn(kmsm.K1_TILE // 2, kmsm.K2_SEGMENT, kmsm.K2_THREADS) == -1


def _state(num_tables, size, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(BN254_FR.p) for _ in range(num_tables * 2 * size)]
    return limb.from_canonical_ints(BN254_FR, vals).reshape(num_tables, 2 * size, 8)


ROUND_KINDS = ("vanilla_like", "single_leaf", "lookup", "beyond_limits")


def round_case(kind, s, device="cpu"):
    """K3's arguments (state, instrs, consts, num_regs, out_reg, degree, ids)
    for one expression at s pairs, from seeds."""
    P = lambda i: ex.Polynomial(Query(i, Rotation(0)))  # noqa: E731
    ids = identity_params(BN254_FR, 2, Fp(12345, BN254_FR), device)
    if kind == "lookup":  # the zero-check of vanilla_plonk_with_lookup_circuit_info
        num_vars = max(1, (s - 1).bit_length()) + 1
        expr = circuits.vanilla_plonk_with_lookup_expression(BN254_FR, num_vars)
        rng = random.Random(s)
        polys = [MLPoly.from_ints(BN254_FR, [rng.randrange(BN254_FR.p) for _ in range(1 << num_vars)], "cpu")
                 for _ in range(1 + max(q.poly for q in expr.used_query()))]
        vp = sc.VirtualPolynomial(expr, polys, [Fp(rng.randrange(BN254_FR.p), BN254_FR) for _ in range(3)],
                                  [[Fp(rng.randrange(BN254_FR.p), BN254_FR) for _ in range(num_vars)]])
        state = sc.ProverState(BN254_FR, num_vars, Fp.zero(BN254_FR), vp)
        prover = sc.EvaluationsProver(state)
        return (state.stacked[:, : 2 * s].contiguous().to(device), prover.instrs,
                prover.consts.to(device), prover.tape.num_regs, prover.tape.out_reg,
                state.degree, ids)
    if kind == "single_leaf":  # degree 1, one leaf: guards the sum's digit weights
        expr, tables = P(0), 1
    elif kind == "vanilla_like":
        expr = (P(0) * P(1) + P(2) * ex.Constant(7) - P(1)) * P(3) + ex.identity() * P(0)
        tables = 4
    else:
        expr, tables = sumcheck_gen.wide_expression()
    tape = compile_tape(expr, BN254_FR)
    state = _state(tables, s, 9).to(device)
    instrs = tape.remapped([("poly", i, 0) for i in range(tables)])
    return (state, instrs, tape.const_rows(BN254_FR, device), tape.num_regs,
            tape.out_reg, expr.degree(), ids)


@pytest.fixture(scope="module")
def round_twin():
    """K3's generated source built with g++, once per expression structure."""
    cache = {}

    def get(instrs, num_regs, out_reg, tables, degree):
        key = sumcheck_gen.structure(instrs, num_regs, out_reg, tables, degree)
        if key not in cache:
            try:
                cache[key] = sumcheck_gen.twin(instrs, num_regs, out_reg, tables, degree)
            except FileNotFoundError as e:
                pytest.skip(f"no host C++ compiler: {e}")
        return cache[key]

    return get


@pytest.mark.parametrize("kind,s", [
    pytest.param(kind, s, id=kind if s == 16 else f"{kind}-s{s}")
    for kind in ROUND_KINDS for s in (1, 16, 100)
])
def test_sumcheck_round_twin(round_twin, kind, s):
    state, instrs, consts, num_regs, out_reg, degree, ids = round_case(kind, s)
    if kind == "beyond_limits":
        assert degree == 9 and num_regs > 32 and state.shape[0] + 1 > 40
    want = ksc.sumcheck_round_plain(BN254_FR, state, instrs, consts, num_regs,
                                    out_reg, degree, ids)
    kern = round_twin(instrs, num_regs, out_reg, state.shape[0], degree)
    got = ksc.round_launch(kern, None, state, consts, degree, ids)
    assert torch.equal(got, want)


def test_sumcheck_fold_twin(twin):
    state = _state(3, 32, 11)
    ch = limb.const(BN254_FR, 987654321)
    want = ksc.fold_plain(BN254_FR, state, ch)
    got = ksc.fold_launch(twin.twin_sumcheck_fold, None, state, ch)
    assert torch.equal(got, want)
