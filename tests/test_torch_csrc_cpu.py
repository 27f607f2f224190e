"""The CUDA sources' arithmetic and kernel bodies, built for the host with g++
(csrc/cpu_twin.cpp), against the port's plain torch versions.

This gives the kernels' code tier-1 coverage before a card runs it: the
field and curve headers, every per-thread body of K1-K4, and the launch
logic of the wrappers (levels, chunk alignment, compaction), which the tests
drive through the twin's entry points with CPU tensors.
"""

import ctypes
import random

import pytest
import torch

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
from plonkish_tpu_torch.piop.sum_check import identity_params
from plonkish_tpu_torch.piop.tape import compile_tape
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
    for name in ("twin_jac_madd", "twin_jac_add"):
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
    lib.twin_jac_dbl.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64]
    build.bind(lib.twin_msm_bucket_level, kmsm.LEVEL_ARGS)
    build.bind(lib.twin_msm_window_reduce, kmsm.WINDOW_ARGS)
    build.bind(lib.twin_sumcheck_round, ksc.ROUND_ARGS)
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
    twin.twin_jac_madd(pj.data_ptr(), qa.data_ptr(), out.data_ptr(), n)
    assert cdev.jac_to_host(C, out) == [p + q for p, q in zip(ps, qs)]
    twin.twin_jac_add(pj.data_ptr(), qj.data_ptr(), out.data_ptr(), n)
    assert cdev.jac_to_host(C, out) == [p + q for p, q in zip(ps, qs)]
    twin.twin_jac_add(qj.data_ptr(), pj.data_ptr(), out.data_ptr(), n)
    assert cdev.jac_to_host(C, out) == [q + p for p, q in zip(ps, qs)]
    twin.twin_jac_dbl(pj.data_ptr(), out.data_ptr(), n)
    assert cdev.jac_to_host(C, out) == [p + p for p in ps]
    # the plain torch formulas agree on the same inputs
    x, y, inf = cdev.unpack_affine(qa)
    plain = cdev.pack_jac(cdev.jmadd(C, cdev.unpack_jac(pj), x, y, inf))
    assert cdev.jac_to_host(C, plain) == [p + q for p, q in zip(ps, qs)]


def _msm_inputs(n, seed, skew=False):
    rng = random.Random(seed)
    pts = _points(n, seed)
    scalars = [rng.randrange(C.scalar.p) for _ in range(n)]
    if skew:  # long runs in few buckets: selector-like scalars
        scalars = [rng.choice([0, 1, 2, C.scalar.p - 1]) for _ in range(n)]
    scalars[0] = 0
    return pts, scalars


@pytest.mark.parametrize("n,skew", [(40, False), (300, True)])
def test_msm_kernels_twin(twin, n, skew):
    pts, scalars = _msm_inputs(n, 5 + n, skew)
    bases = cdev.affine_from_host(C, pts, "cpu")
    c = tmsm.window_size(n)
    w = tmsm.num_windows(C, c)
    keys, src, nb = tmsm.msm_entries(limb.from_ints(scalars), c, w)
    plain = kmsm.msm_bucket_sums_plain(C, bases, keys, src, w * nb)
    kern = kmsm.bucket_levels(twin.twin_msm_bucket_level, None, bases, keys, src, w * nb)
    assert cdev.jac_to_host(C, kern) == cdev.jac_to_host(C, plain)
    buckets = kern.reshape(w, nb, 3, 8)
    wplain = kmsm.msm_window_sums_plain(C, buckets)
    wkern = kmsm.window_launch(twin.twin_msm_window_reduce, None, buckets)
    assert cdev.jac_to_host(C, wkern) == cdev.jac_to_host(C, wplain)
    assert tmsm.combine_windows(C, wkern, c) == msm_host(scalars, pts)


def _state(num_tables, size, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(BN254_FR.p) for _ in range(num_tables * 2 * size)]
    return limb.from_canonical_ints(BN254_FR, vals).reshape(num_tables, 2 * size, 8)


@pytest.mark.parametrize("kind", ["vanilla_like", "single_leaf"])
def test_sumcheck_round_twin(twin, kind):
    P = lambda i: ex.Polynomial(Query(i, Rotation(0)))  # noqa: E731
    if kind == "single_leaf":  # degree 1, one leaf: guards the sum's digit weights
        expr, degree, tables = P(0), 1, 1
    else:
        expr = (P(0) * P(1) + P(2) * ex.Constant(7) - P(1)) * P(3) + ex.identity() * P(0)
        degree, tables = 3, 4
    tape = compile_tape(expr, BN254_FR)
    rows = {("poly", i, 0): i for i in range(tables)}
    rows[("identity",)] = tables
    instrs = tape.instrs.copy()
    load = instrs[:, 0] == 4
    instrs[load, 1] = [rows[tape.leaf_keys[j]] for j in instrs[load, 1]]
    state = _state(tables, 16, 9)
    ids = identity_params(BN254_FR, 2, Fp(12345, BN254_FR), "cpu")
    consts = tape.const_rows(BN254_FR, "cpu")
    want = ksc.sumcheck_round_plain(BN254_FR, state, instrs, consts, tape.num_regs,
                                    tape.out_reg, degree, ids)
    got = ksc.round_launch(twin.twin_sumcheck_round, None, state, instrs, consts,
                           tape.num_regs, tape.out_reg, degree, ids)
    assert torch.equal(got, want)


def test_sumcheck_round_twin_rejects_large_tape(twin):
    # the limits live in csrc/sumcheck.cu only; the wrapper reports them
    tape = compile_tape(ex.Polynomial(Query(0, Rotation(0))), BN254_FR)
    state = _state(1, 4, 10)
    ids = identity_params(BN254_FR, 2, Fp(1, BN254_FR), "cpu")
    with pytest.raises(ValueError, match="tape too large"):
        ksc.round_launch(twin.twin_sumcheck_round, None, state, tape.instrs,
                         tape.const_rows(BN254_FR, "cpu"), tape.num_regs,
                         tape.out_reg, 9, ids)


def test_sumcheck_fold_twin(twin):
    state = _state(3, 32, 11)
    ch = limb.const(BN254_FR, 987654321)
    want = ksc.fold_plain(BN254_FR, state, ch)
    got = ksc.fold_launch(twin.twin_sumcheck_fold, None, state, ch)
    assert torch.equal(got, want)
