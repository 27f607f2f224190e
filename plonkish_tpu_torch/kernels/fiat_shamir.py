"""K6, the device-resident Fiat-Shamir round message: the launch side.

A kernel of the port only: the JAX package runs the round message as one
jitted XLA program (plonkish_tpu/piop/fiat_shamir.py:314-455), not in Pallas.
The CUDA source is ``csrc/fiat_shamir.cu`` over ``csrc/fiat_shamir.cuh``: one
warp absorbs the round's message into the transcript's sponge, squeezes the
challenge and computes what the next round needs, so that K3 -> K6 -> K4
enqueue with no host read.  The plain versions and the functions the prover
calls are in ``piop/fiat_shamir.py``, which also documents the layouts.

Every buffer is ``int32`` and contiguous on one device, written in place by
the kernel: the sponge ``[SPONGE_WORDS]``, the running scalars, the message
and challenge row, the challenge in Montgomery form and the next identity
rows.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.spec import FieldSpec
from . import LAUNCHES, build, field_id

SPONGE_WORDS = 2 * 25 + 2 * 17 + 1  # csrc/fiat_shamir.cuh FS_SPONGE_WORDS
MAX_DEGREE = 32  # FS_MAX_DEGREE
ROUND_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_void_p]
COEFF_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]


def _check(device, **tensors):
    """Each named tensor must be int32, contiguous, on `device`, of its
    shape (given as (tensor, shape) pairs)."""
    for name, (t, shape) in tensors.items():
        if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be int32{list(shape)}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")


def round_launch(fn, stream, spec: FieldSpec, degree: int, sums, scal, sponge, fixed, rows,
                 out, ch_mont, ids_next):
    """Launch K6's Evaluations round through `fn` (``fs_round`` or its host
    twin)."""
    field = field_id(spec)
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"K6 takes degrees 1..{MAX_DEGREE}, not {degree}")
    _check(sums.device, sums=(sums, (degree, 8)), scal=(scal, (2, 8)),
           sponge=(sponge, (SPONGE_WORDS,)), fixed=(fixed, (2 * (degree + 1), 8)),
           rows=(rows, (2, 3, 8)), out=(out, (degree + 2, 8)), ch_mont=(ch_mont, (8,)),
           ids_next=(ids_next, (3, 8)))
    rc = fn(sums.data_ptr(), scal.data_ptr(), sponge.data_ptr(), fixed.data_ptr(),
            rows.data_ptr(), degree, out.data_ptr(), ch_mont.data_ptr(), ids_next.data_ptr(),
            field, stream)
    if rc != 0:
        raise RuntimeError(f"fs_round launch failed: CUDA error {rc}")
    LAUNCHES["fs_round_message"] += 1


def coeff_launch(fn, stream, spec: FieldSpec, v, scal, sponge, c0_base, out, ch_mont):
    """Launch K6's Coefficients round through `fn` (``fs_coeff`` or its host
    twin)."""
    field = field_id(spec)
    _check(v.device, v=(v, (2, 8)), scal=(scal, (8,)), sponge=(sponge, (SPONGE_WORDS,)),
           c0_base=(c0_base, (8,)), out=(out, (4, 8)), ch_mont=(ch_mont, (8,)))
    rc = fn(v.data_ptr(), scal.data_ptr(), sponge.data_ptr(), c0_base.data_ptr(),
            out.data_ptr(), ch_mont.data_ptr(), field, stream)
    if rc != 0:
        raise RuntimeError(f"fs_coeff launch failed: CUDA error {rc}")
    LAUNCHES["fs_coeff_message"] += 1


def _stream(t):
    if t.device.type != "cuda":
        raise ValueError("K6 takes CUDA tensors")
    return torch.cuda.current_stream(t.device).cuda_stream


def round_cuda(spec, degree, sums, scal, sponge, fixed, rows, out, ch_mont, ids_next):
    stream = _stream(sums)
    fn = build.bind(build.lib().fs_round, ROUND_ARGS)
    round_launch(fn, stream, spec, degree, sums, scal, sponge, fixed, rows, out, ch_mont,
                 ids_next)


def coeff_cuda(spec, v, scal, sponge, c0_base, out, ch_mont):
    stream = _stream(v)
    fn = build.bind(build.lib().fs_coeff, COEFF_ARGS)
    coeff_launch(fn, stream, spec, v, scal, sponge, c0_base, out, ch_mont)
