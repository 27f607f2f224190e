"""The IPA base fold, two kernels of the port only, with their plain versions.

Each round of the multilinear IPA's open folds the generator basis:
``out[i] = L[i] + xi * R[i]`` over the halves L, R of the basis, with one
challenge xi for the whole round (plonkish_tpu/pcs/ipa.py:157-160, where XLA
fuses the ``lax.scan`` of 254 doubling-and-add steps of
``curves/device.py::scalar_mul_const``; no Pallas kernel computes it).  The
CUDA source is ``csrc/ipa.cu``, two launches a fold:

- the ladder (``ladder_cuda``): one thread per point walks one schedule of
  xi's digits, the same for every point (``digits``: xi split by the
  curve's endomorphism and recoded over the Eisenstein integers), and writes
  ``L + xi * R`` as Jacobian ``int32[N, 3, 8]``;
- the conversion (``affine_cuda``): Montgomery's batch inversion over chunks
  of ``FOLD_CHUNK`` points, affine ``int32[N, 2, 8]`` out, the basis K1 reads
  in the next round.

Inputs: L and R as affine ``int32[N, 2, 8]`` (Montgomery, identity as (0, 0))
on Grumpkin G1, xi a host integer below the curve's order.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..curves import device as cdev
from ..curves.specs import GRUMPKIN_G1, CurveSpec
from . import LAUNCHES, curve_id
from . import build

LADDER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
AFFINE_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_void_p]
MAX_DIGITS = 160  # csrc/ipa.cu FOLD_MAX_DIGITS
FOLD_CHUNK = 32  # FOLD_CHUNK
# digit codes (FOLD_NONZERO, FOLD_Q, FOLD_NEG): j | Q | NEG | NONZERO
NONZERO, FAMILY_Q, NEG = 16, 4, 8


def _eis_mul(a, b):
    """(a0 + a1 w) (b0 + b1 w) with w^2 = -1 - w."""
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0] - a[1] * b[1])


@functools.lru_cache(maxsize=None)
def digit_table():
    """The 12 nonzero digits +-w^j and +-w^j (1 - w), j < 3, keyed by their
    residue mod 4: each odd residue (not both coordinates even) has exactly
    one.  Values (code, (d0, d1)), d0 + d1 w the digit."""
    table = {}
    power = (1, 0)
    for j in range(3):
        for family, base in ((0, power), (FAMILY_Q, _eis_mul(power, (1, -1)))):
            for neg, sign in ((0, 1), (NEG, -1)):
                d = (sign * base[0], sign * base[1])
                table[(d[0] & 3, d[1] & 3)] = (NONZERO | j | family | neg, d)
        power = _eis_mul(power, (0, 1))
    assert len(table) == 12
    return table


def digits(curve: CurveSpec, xi: int):
    """xi's digit codes, most significant first: xi = k1 + k2 lambda
    (``_glv_split``), and k1 + k2 w expanded as sum_s d_s 2^s with d_s 0 or
    the one digit congruent to the rest mod 4, so that a nonzero digit is
    followed by a zero."""
    k1, k2 = cdev._glv_split(curve, int(xi) % curve.scalar.p)
    table = digit_table()
    out = []
    while k1 or k2:
        code, d = (0, (0, 0)) if not (k1 | k2) & 1 else table[(k1 & 3, k2 & 3)]
        out.append(code)
        k1, k2 = (k1 - d[0]) >> 1, (k2 - d[1]) >> 1
    if len(out) > MAX_DIGITS:
        raise ValueError(f"xi needs {len(out)} digits, more than the kernel's {MAX_DIGITS}")
    return out[::-1]


@functools.lru_cache(maxsize=None)
def _beta_words(curve: CurveSpec):
    """beta in Montgomery form as 8 words, host memory (the schedule's)."""
    v = curve.base.to_mont(cdev._endomorphism(curve)[0])
    return (ctypes.c_uint32 * 8)(*[(v >> (32 * w)) & 0xFFFFFFFF for w in range(8)])


def _check_affine(curve: CurveSpec, **tensors):
    if curve is not GRUMPKIN_G1:
        raise NotImplementedError("the IPA base fold is built for Grumpkin G1")
    for name, (t, width) in tensors.items():
        if t.dtype != torch.int32 or t.dim() != 3 or tuple(t.shape[1:]) != (width, 8):
            raise ValueError(f"{name} must be int32[N, {width}, 8], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ladder_launch(fn, stream, curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    """Launch the ladder through `fn` (``ipa_fold_ladder`` or its host twin):
    L + xi * R, Jacobian int32[N, 3, 8]."""
    _check_affine(curve, left=(left, 2), right=(right, 2))
    if left.shape != right.shape or left.device != right.device:
        raise ValueError("left and right must have one shape and one device")
    codes = digits(curve, xi)
    buf = (ctypes.c_uint8 * max(1, len(codes)))(*codes)
    jac = torch.empty((left.shape[0], 3, 8), dtype=torch.int32, device=left.device)
    rc = fn(left.data_ptr(), right.data_ptr(), left.shape[0],
            ctypes.addressof(_beta_words(curve)), ctypes.addressof(buf), len(codes),
            jac.data_ptr(), curve_id(curve), stream)
    if rc != 0:
        raise RuntimeError(f"ipa_fold_ladder launch failed: code {rc}")
    LAUNCHES["ipa_base_fold"] += 1
    return jac


def affine_launch(fn, stream, curve: CurveSpec, jac) -> torch.Tensor:
    """Launch the conversion through `fn` (``ipa_fold_affine`` or its host
    twin): Jacobian int32[N, 3, 8] -> affine int32[N, 2, 8]."""
    _check_affine(curve, jac=(jac, 3))
    out = torch.empty((jac.shape[0], 2, 8), dtype=torch.int32, device=jac.device)
    rc = fn(jac.data_ptr(), jac.shape[0], out.data_ptr(), curve_id(curve), stream)
    if rc != 0:
        raise RuntimeError(f"ipa_fold_affine launch failed: code {rc}")
    LAUNCHES["ipa_fold_affine"] += 1
    return out


def ladder_plain(curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    """padd(L, scalar_mul_const(R, xi)), Jacobian storage (another Jacobian
    form of the same points than the kernel's)."""
    return cdev.padd(curve, cdev.affine_to_jac_storage(curve, left),
                     cdev.scalar_mul_const(curve, right, xi))


def affine_plain(curve: CurveSpec, jac) -> torch.Tensor:
    """Jacobian storage to affine by one batch inversion."""
    return cdev.jac_to_affine(curve, cdev.unpack_jac(jac))


def base_fold_plain(curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    return affine_plain(curve, ladder_plain(curve, left, right, xi))


def _cuda(name, args, t):
    if t.device.type != "cuda":
        raise ValueError("the IPA base fold takes CUDA tensors")
    fn = build.bind(getattr(build.lib(), name), args)
    return fn, torch.cuda.current_stream(t.device).cuda_stream


def ladder_cuda(curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    return ladder_launch(*_cuda("ipa_fold_ladder", LADDER_ARGS, left), curve, left, right, xi)


def affine_cuda(curve: CurveSpec, jac) -> torch.Tensor:
    return affine_launch(*_cuda("ipa_fold_affine", AFFINE_ARGS, jac), curve, jac)


def base_fold_cuda(curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    return affine_cuda(curve, ladder_cuda(curve, left, right, xi))


def base_fold(curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    """L + xi * R for every pair of affine points, as affine points."""
    if left.device.type == "cpu":
        return base_fold_plain(curve, left, right, xi)
    return base_fold_cuda(curve, left, right, xi)
