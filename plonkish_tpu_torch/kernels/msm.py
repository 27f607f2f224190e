"""MSM kernels K1 (bucket sums) and K2 (window sums and their combine), with
plain versions.

K1 replaces plonkish_tpu/pallas/msm.py::_bucket_kernel (pallas/msm.py:46) and
K2 replaces ::_reduce_kernel (pallas/msm.py:119), both launched there by
``_msm_windows_pallas_jit``; K2 also does the window combine that the
reference leaves to the host.  The kernels are templates in ``csrc/msm.cuh``
over the shared headers ``csrc/field.cuh`` and ``csrc/curve.cuh``; the entry
points and BN254's kernels are compiled in ``csrc/msm.cu``, Grumpkin's in
``csrc/msm_grumpkin.cu``.

Both run on BN254 G1 (coordinates in Fq; KZG, Gemini, Zeromorph) and on
Grumpkin G1 (coordinates in BN254's Fr; IPA, Hyrax): the CUDA code is a
template over the base field, and the curve is an argument of every entry
point (``kernels.CURVES``).

Inputs of K1: the affine basis ``int32[N, 2, 8]`` (Montgomery, over the
curve's base field, identity as (0, 0)), and every (window, point) digit of
the recoded scalars, sorted by key: ``keys int32[M]`` (window * B + bucket,
or the sentinel ``num_keys`` for a zero digit) and ``src int32[M]`` (2 *
point index + sign).  Output: one
Jacobian sum per key, ``int32[num_keys, 3, 8]`` (identity where no live entry
has the key).

Input of K2: the buckets as ``int32[W, B, 3, 8]`` and the window width c;
output the one Jacobian point ``sum_w 2^(c*w) * sum_b b * bucket[w, b]`` as
``int32[3, 8]``.

On a CUDA tensor both enqueue a number of launches that follows from the
sizes alone, and read nothing back.  Jacobian coordinates are not unique, so
the kernels and the plain versions are compared after conversion to affine
points.
"""

from __future__ import annotations

import ctypes

import torch

from ..curves import device as cdev
from ..curves.host import AffinePoint
from ..curves.specs import BN254_G1
from ..fields import limb
from . import LAUNCHES, curve_id
from . import build

# Sizes compiled into csrc/msm.cuh (checked by ``msm_check_layout``).
K1_TILE = 4096  # sorted entries per block and level: 128 threads x 32
K2_SEGMENT = 16  # buckets per thread at K2's first level
K2_THREADS = 128  # items per block at every K2 level
PLAIN_CHUNK = 1 << 20  # point additions per vectorised step of the plain K1


def _check(t: torch.Tensor, dtype, tail, name):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tail and tuple(t.shape[-len(tail):]) != tuple(tail):
        raise ValueError(f"{name}: bad shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_layout(lib) -> None:
    """Raise unless `lib` (the kernel library or its host twin) was built
    with this module's K1_TILE, K2_SEGMENT and K2_THREADS."""
    fn = build.bind(lib.msm_check_layout, [ctypes.c_int] * 3)
    if fn(K1_TILE, K2_SEGMENT, K2_THREADS) != 0:
        raise ValueError("kernels/msm.py and csrc/msm.cuh disagree on the MSM layout")


def _tree_sum(curve, pts, groups: int):
    """Sum each of `groups` equal runs of the batch `pts` (digit tuples of
    width groups * size) in a pairwise tree -> digit tuples of width groups."""
    size = pts[0].shape[1] // groups
    full = 1 << max(0, (size - 1).bit_length())
    dev = pts[0].device
    acc = tuple(
        torch.cat([v.reshape(16, groups, size),
                   torch.zeros(16, groups, full - size, dtype=v.dtype, device=dev)], 2)
        for v in pts
    )
    while full > 1:
        full //= 2
        p = tuple(v[:, :, :full].reshape(16, -1) for v in acc)
        q = tuple(v[:, :, full:].reshape(16, -1) for v in acc)
        acc = tuple(v.reshape(16, groups, full) for v in cdev.jadd(curve, p, q))
    return tuple(v.reshape(16, groups) for v in acc)


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
    """Segmented sums of the sorted live entries (keys below the sentinel),
    pairwise within each run of equal keys (about 2M point additions over
    log2(longest run) levels)."""
    live = keys < num_keys
    keys, src = keys[live], src[live]
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


def bucket_level_sizes(m: int):
    """[(entries, tiles)] of K1's levels over m sorted entries: a level of
    t > 1 tiles leaves 2t carry slots to the next."""
    sizes = []
    while m > 0:
        tiles = -(-m // K1_TILE)
        sizes.append((m, tiles))
        if tiles == 1:
            break
        m = 2 * tiles
    return sizes


def bucket_levels(level_fn, stream, bases, keys, src, num_keys, curve=BN254_G1):
    """Drive K1's levels through `level_fn` (the C entry point
    ``msm_bucket_level`` or its host twin): level 0 over the sorted entries,
    each later one over the previous level's carry slots, until a level fits
    one tile."""
    cid = curve_id(curve)
    dev = bases.device
    buckets = limb.zeros((num_keys, 3), dev)
    k_in, aux, pts, affine = keys, src, bases, 1
    for m, tiles in bucket_level_sizes(keys.numel()):
        ck = torch.empty((2 * tiles,), dtype=torch.int32, device=dev)
        cf = torch.empty((2 * tiles,), dtype=torch.int32, device=dev)
        cp = torch.empty((2 * tiles, 3, 8), dtype=torch.int32, device=dev)
        rc = level_fn(k_in.data_ptr(), aux.data_ptr(), pts.data_ptr(), m, num_keys,
                      affine, buckets.data_ptr(), ck.data_ptr(), cf.data_ptr(),
                      cp.data_ptr(), cid, stream)
        if rc != 0:
            raise RuntimeError(f"msm_bucket_level launch failed: CUDA error {rc}")
        LAUNCHES["msm_bucket_sums"] += 1
        k_in, aux, pts, affine = ck, cf, cp, 0
    return buckets


LEVEL_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
WINDOW_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
COMBINE_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = build.lib()
    check_layout(lib)
    return lib


def msm_bucket_sums_cuda(curve, bases, keys, src, num_keys):
    curve_id(curve)
    _check(bases, torch.int32, (2, 8), "bases")
    _check(keys, torch.int32, (), "keys")
    _check(src, torch.int32, (), "src")
    dev = bases.device
    if dev.type != "cuda" or keys.device != dev or src.device != dev:
        raise ValueError("bases, keys and src must be on one CUDA device")
    if bases.data_ptr() % 16:
        raise ValueError("bases must be 16-byte aligned (K1 copies its points with cp.async)")
    fn = build.bind(_lib().msm_bucket_level, LEVEL_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return bucket_levels(fn, stream, bases, keys, src, num_keys, curve)


def bucket_sums(curve, bases, keys, src, num_keys):
    """K1: one Jacobian sum per (window, bucket) key."""
    if bases.device.type == "cpu":
        return msm_bucket_sums_plain(curve, bases, keys, src, num_keys)
    return msm_bucket_sums_cuda(curve, bases, keys, src, num_keys)


# ---------------------------------------------------------------------------
# K2: window sums and their combine
# ---------------------------------------------------------------------------

def msm_window_combine_plain(curve, window_sums, c):
    """sum_w 2^(c*w) * window_sums[w] -> int32[3, 8], combined on the host as
    the reference combines its window kernel's output
    (plonkish_tpu/curves/msm.py:616-625): one read of the W window sums, then
    Horner over the windows in Python integers (about 256 doublings of one
    point, a chain that no batch of torch operations shortens)."""
    acc = AffinePoint.identity(curve)
    for p in reversed(cdev.jac_to_host(curve, window_sums)):
        for _ in range(c):
            acc = acc.double()
        acc = acc + p
    return cdev.affine_to_jac_storage(
        curve, cdev.affine_from_host(curve, [acc], window_sums.device))[0]


def msm_window_sums_plain(curve, buckets, c):
    """sum_b b * bucket[w, b] per window (every bucket times its index by
    double-and-add, then a tree sum over the bucket axis), combined into one
    point by ``msm_window_combine_plain``."""
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
    sums = cdev.pack_jac(_tree_sum(curve, acc, w))
    return msm_window_combine_plain(curve, sums, c)


def window_levels(level_fn, combine_fn, stream, buckets, c, curve=BN254_G1):
    """Drive K2 through `level_fn` and `combine_fn` (``msm_window_level`` and
    ``msm_window_combine`` or their host twins): levels until one item per
    window is left, then the combine."""
    cid = curve_id(curve)
    w, b = buckets.shape[:2]
    dev = buckets.device
    src, n_in, level = buckets, b, 0
    while True:
        items = -(-n_in // K2_SEGMENT) if level == 0 else n_in
        n_out = -(-items // K2_THREADS)
        out = torch.empty((w, n_out, 2, 3, 8), dtype=torch.int32, device=dev)
        rc = level_fn(src.data_ptr(), level, n_in, w, out.data_ptr(), n_out, cid, stream)
        if rc != 0:
            raise RuntimeError(f"msm_window_level launch failed: CUDA error {rc}")
        LAUNCHES["msm_window_sums"] += 1
        if n_out == 1:
            break
        src, n_in, level = out, n_out, level + 1
    point = torch.empty((3, 8), dtype=torch.int32, device=dev)
    rc = combine_fn(out.data_ptr(), w, c, point.data_ptr(), cid, stream)
    if rc != 0:
        raise RuntimeError(f"msm_window_combine launch failed: code {rc} ({w} windows)")
    LAUNCHES["msm_window_sums"] += 1
    return point


def msm_window_sums_cuda(curve, buckets, c):
    curve_id(curve)
    _check(buckets, torch.int32, (3, 8), "buckets")
    if buckets.dim() != 4 or buckets.device.type != "cuda":
        raise ValueError("buckets must be a CUDA int32[W, B, 3, 8]")
    lib = _lib()
    level_fn = build.bind(lib.msm_window_level, WINDOW_ARGS)
    combine_fn = build.bind(lib.msm_window_combine, COMBINE_ARGS)
    stream = torch.cuda.current_stream(buckets.device).cuda_stream
    return window_levels(level_fn, combine_fn, stream, buckets, c, curve)


def window_sums(curve, buckets, c):
    """K2: sum_w 2^(c*w) * sum_b b * bucket[w, b] as one Jacobian point."""
    if buckets.device.type == "cpu":
        return msm_window_sums_plain(curve, buckets, c)
    return msm_window_sums_cuda(curve, buckets, c)
