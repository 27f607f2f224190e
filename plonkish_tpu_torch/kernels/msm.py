"""MSM kernels K1 (bucket sums) and K2 (window sums), with plain versions.

K1 replaces plonkish_tpu/pallas/msm.py::_bucket_kernel (pallas/msm.py:46) and
K2 replaces ::_reduce_kernel (pallas/msm.py:119), both launched there by
``_msm_windows_pallas_jit``.  The CUDA sources are ``csrc/msm.cu`` over the
shared headers ``csrc/field.cuh`` and ``csrc/curve.cuh``.

Inputs of K1: the affine basis ``int32[N, 2, 8]`` (Montgomery Fq, identity as
(0, 0)), and the (window, bucket) entries of the recoded scalars, sorted by
key: ``keys int32[M]`` (window * B + bucket) and ``src int32[M]``
(2 * point index + sign).  Output: one Jacobian sum per key,
``int32[num_keys, 3, 8]`` (identity where no entry has the key).

Input of K2: the buckets as ``int32[W, B, 3, 8]``; output the window sums
``sum_b b * bucket[w, b]`` as ``int32[W, 3, 8]`` Jacobian.

Jacobian coordinates are not unique, so the kernels and the plain versions
are compared after conversion to affine points.
"""

from __future__ import annotations

import ctypes

import torch

from ..curves import device as cdev
from ..curves.specs import BN254_G1, CurveSpec
from ..fields import limb
from . import LAUNCHES
from . import build

CHUNK = 32  # sorted entries per thread and level in K1
WINDOW_THREADS = 128  # threads per window in K2
PLAIN_CHUNK = 1 << 20  # point additions per vectorised step of the plain K1


def _check(t: torch.Tensor, dtype, tail, name):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tail and tuple(t.shape[-len(tail):]) != tuple(tail):
        raise ValueError(f"{name}: bad shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_curve(curve: CurveSpec):
    if curve is not BN254_G1:
        raise NotImplementedError("the MSM kernels are built for BN254 G1")


# ---------------------------------------------------------------------------
# K1: bucket sums
# ---------------------------------------------------------------------------

def _entry_points(curve, bases, src):
    """Affine entry points (sign applied) as Jacobian digit tuples."""
    x, y, inf = cdev.unpack_affine(bases[(src >> 1).long()])
    neg = (src & 1).bool() & ~inf
    c = limb._consts(curve.base, bases.device)
    y = torch.where(neg, limb.d_neg(y, c), y)
    return cdev.affine_to_jac(curve, x, y, inf)


def msm_bucket_sums_plain(curve, bases, keys, src, num_keys):
    """Segmented sums of the sorted entries, pairwise within each run of
    equal keys (about 2M point additions over log2(longest run) levels)."""
    pts = _entry_points(curve, bases, src)
    k = keys.long()
    while k.numel() > 1:
        same_next = k[1:] == k[:-1]
        if not bool(same_next.any()):
            break
        m = k.numel()
        pos = torch.arange(m, device=k.device)
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=k.device), ~same_next])
        start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
        left = pos[(pos - start) % 2 == 0]
        has_next = torch.cat([same_next, torch.zeros(1, dtype=torch.bool, device=k.device)])[left]
        right = torch.clamp(left + 1, max=m - 1)
        sums = []
        for lo in range(0, left.numel(), PLAIN_CHUNK):
            sl, sr = left[lo: lo + PLAIN_CHUNK], right[lo: lo + PLAIN_CHUNK]
            p = tuple(v[:, sl] for v in pts)
            q = tuple(v[:, sr] for v in pts)
            z = torch.where(has_next[lo: lo + PLAIN_CHUNK], q[2], torch.zeros_like(q[2]))
            sums.append(cdev.jadd(curve, p, (q[0], q[1], z)))
        pts = tuple(torch.cat([s[i] for s in sums], dim=1) for i in range(3))
        k = k[left]
    out = limb.zeros((num_keys, 3), bases.device)
    if k.numel():
        out[k] = cdev.pack_jac(pts)
    return out


def bucket_levels(level_fn, stream, bases, keys, src, num_keys):
    """Drive K1's levels: launch, keep the flagged partial sums, repeat on
    them (with the other chunk alignment) until one sum per key is left.
    `level_fn` is the C entry point ``msm_bucket_level`` (or its host twin)."""
    dev = bases.device
    out_buckets = limb.zeros((num_keys, 3), dev)
    m = keys.numel()
    if m == 0:
        return out_buckets
    num_unique = int((keys[1:] != keys[:-1]).sum().item()) + 1
    pts = torch.zeros((1, 3, 8), dtype=torch.int32, device=dev)
    affine, level, stalled = 1, 0, 0
    while True:
        out = torch.empty((m, 3, 8), dtype=torch.int32, device=dev)
        flag = torch.empty((m,), dtype=torch.uint8, device=dev)
        offset = (CHUNK // 2) * (level % 2)
        rc = level_fn(keys.data_ptr(), m, src.data_ptr(), bases.data_ptr(),
                      pts.data_ptr(), affine, CHUNK, offset, out.data_ptr(),
                      flag.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"msm_bucket_level launch failed: CUDA error {rc}")
        LAUNCHES["msm_bucket_sums"] += 1
        sel = flag.nonzero().squeeze(1)
        keys, pts = keys[sel].contiguous(), out[sel].contiguous()
        stalled = stalled + 1 if keys.numel() == m and not affine else 0
        if stalled > 2:
            raise RuntimeError("msm_bucket_level made no progress")
        m = keys.numel()
        affine, level = 0, level + 1
        if m == num_unique:
            break
    out_buckets[keys.long()] = pts
    return out_buckets


LEVEL_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
WINDOW_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_void_p]


def msm_bucket_sums_cuda(curve, bases, keys, src, num_keys):
    _check_curve(curve)
    _check(bases, torch.int32, (2, 8), "bases")
    _check(keys, torch.int32, (), "keys")
    _check(src, torch.int32, (), "src")
    dev = bases.device
    if dev.type != "cuda" or keys.device != dev or src.device != dev:
        raise ValueError("bases, keys and src must be on one CUDA device")
    fn = build.bind(build.lib().msm_bucket_level, LEVEL_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return bucket_levels(fn, stream, bases, keys, src, num_keys)


def bucket_sums(curve, bases, keys, src, num_keys):
    """K1: one Jacobian sum per (window, bucket) key."""
    if bases.device.type == "cpu":
        return msm_bucket_sums_plain(curve, bases, keys, src, num_keys)
    return msm_bucket_sums_cuda(curve, bases, keys, src, num_keys)


# ---------------------------------------------------------------------------
# K2: window sums
# ---------------------------------------------------------------------------

def msm_window_sums_plain(curve, buckets):
    """sum_b b * bucket[w, b] per window: every bucket times its index by
    double-and-add, then a tree sum over the bucket axis."""
    w, b = buckets.shape[:2]
    dev = buckets.device
    pts = cdev.unpack_jac(buckets.reshape(w * b, 3, 8))
    idx = torch.arange(b, device=dev).repeat(w)
    zero = torch.zeros_like(pts[0])
    acc = (zero, zero, zero)
    for bit in reversed(range(max(1, (b - 1).bit_length()))):
        acc = cdev.jdbl(curve, acc)
        added = cdev.jadd(curve, acc, pts)
        sel = ((idx >> bit) & 1).bool()
        acc = tuple(torch.where(sel, a2, a1) for a1, a2 in zip(acc, added))
    size = 1 << max(0, (b - 1).bit_length())
    acc = tuple(
        torch.cat([v.reshape(16, w, b), torch.zeros(16, w, size - b, dtype=v.dtype, device=dev)], 2)
        for v in acc
    )
    while size > 1:
        size //= 2
        p = tuple(v[:, :, :size].reshape(16, -1) for v in acc)
        q = tuple(v[:, :, size:].reshape(16, -1) for v in acc)
        acc = tuple(v.reshape(16, w, size) for v in cdev.jadd(curve, p, q))
    return cdev.pack_jac(tuple(v.reshape(16, w) for v in acc))


def window_launch(reduce_fn, stream, buckets):
    """Launch K2 through `reduce_fn` (``msm_window_reduce`` or its host twin)."""
    w, b = buckets.shape[:2]
    out = torch.empty((w, 3, 8), dtype=torch.int32, device=buckets.device)
    rc = reduce_fn(buckets.data_ptr(), w, b, WINDOW_THREADS, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"msm_window_reduce launch failed: CUDA error {rc}")
    LAUNCHES["msm_window_sums"] += 1
    return out


def msm_window_sums_cuda(curve, buckets):
    _check_curve(curve)
    _check(buckets, torch.int32, (3, 8), "buckets")
    if buckets.dim() != 4 or buckets.device.type != "cuda":
        raise ValueError("buckets must be a CUDA int32[W, B, 3, 8]")
    fn = build.bind(build.lib().msm_window_reduce, WINDOW_ARGS)
    stream = torch.cuda.current_stream(buckets.device).cuda_stream
    return window_launch(fn, stream, buckets)


def window_sums(curve, buckets):
    """K2: per-window weighted bucket sums."""
    if buckets.device.type == "cpu":
        return msm_window_sums_plain(curve, buckets)
    return msm_window_sums_cuda(curve, buckets)
