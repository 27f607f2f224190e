"""The IPA base fold, a kernel of the port only, with its plain version.

Each round of the multilinear IPA's open folds the generator basis:
``out[i] = L[i] + xi * R[i]`` over the halves L, R of the basis, with one
challenge xi for the whole round (plonkish_tpu/pcs/ipa.py:157-160, where XLA
fuses the ``lax.scan`` of 254 doubling-and-add steps of
``curves/device.py::scalar_mul_const``; no Pallas kernel computes it).  The
CUDA source is ``csrc/ipa.cu``: one thread per point, a double-and-add over
xi's bits, the result made affine in the same thread, so that it is the
basis K1 reads in the next round.

Inputs: L and R as affine ``int32[N, 2, 8]`` (Montgomery, identity as (0, 0))
on Grumpkin G1, xi a host integer below the curve's order.  Output: affine
``int32[N, 2, 8]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..curves import device as cdev
from ..curves.specs import GRUMPKIN_G1, CurveSpec
from ..fields import limb
from . import LAUNCHES, curve_id
from . import build

FOLD_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def base_fold_plain(curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    """padd(L, scalar_mul_const(R, xi)), made affine by one batch inversion."""
    folded = cdev.padd(curve, cdev.affine_to_jac_storage(curve, left),
                       cdev.scalar_mul_const(curve, right, xi))
    return cdev.jac_to_affine(curve, cdev.unpack_jac(folded))


def _scalar(curve: CurveSpec, xi: int, device):
    """xi's canonical words int32[8] on `device` and its bit length."""
    k = int(xi) % curve.scalar.p
    return limb.from_ints([k], device)[0], k.bit_length()


def base_fold_launch(fold_fn, stream, curve: CurveSpec, left, right, xi: int):
    """Launch the fold through `fold_fn` (``ipa_base_fold`` or its host twin)."""
    if curve is not GRUMPKIN_G1:
        raise NotImplementedError("the IPA base fold is built for Grumpkin G1")
    for name, t in (("left", left), ("right", right)):
        if t.dtype != torch.int32 or t.dim() != 3 or tuple(t.shape[1:]) != (2, 8):
            raise ValueError(f"{name} must be affine int32[N, 2, 8], got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if left.shape != right.shape or left.device != right.device:
        raise ValueError("left and right must have one shape and one device")
    words, nbits = _scalar(curve, xi, left.device)
    out = torch.empty_like(left)
    rc = fold_fn(left.data_ptr(), right.data_ptr(), left.shape[0], words.data_ptr(), nbits,
                 out.data_ptr(), curve_id(curve), stream)
    if rc != 0:
        raise RuntimeError(f"ipa_base_fold launch failed: code {rc}")
    LAUNCHES["ipa_base_fold"] += 1
    return out


def base_fold_cuda(curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    if left.device.type != "cuda":
        raise ValueError("the bases must be CUDA tensors")
    fn = build.bind(build.lib().ipa_base_fold, FOLD_ARGS)
    stream = torch.cuda.current_stream(left.device).cuda_stream
    return base_fold_launch(fn, stream, curve, left, right, xi)


def base_fold(curve: CurveSpec, left, right, xi: int) -> torch.Tensor:
    """L + xi * R for every pair of affine points, as affine points."""
    if left.device.type == "cpu":
        return base_fold_plain(curve, left, right, xi)
    return base_fold_cuda(curve, left, right, xi)
