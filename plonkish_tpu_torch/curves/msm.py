"""Multi-scalar multiplication (port of plonkish_tpu/curves/msm.py).

Pippenger with signed windows, shaped for a card with atomics and a fast sort
rather than for the TPU's lane-private buckets:

1. every scalar is recoded on the device into signed c-bit digits, giving
   B = 2^(c-1) + 1 buckets per window (bucket 0 unused);
2. the non-zero (window, bucket) entries are sorted by key, so each bucket's
   points are one contiguous run;
3. K1 (``kernels.msm.bucket_sums``) reduces each run with complete mixed
   additions, so repeated points, P + (-P) and the identity come out right
   and no random blind is needed;
4. K2 (``kernels.msm.window_sums``) forms sum_b b * B_b per window;
5. the host combines the windows with c doublings each.

Every MSM takes this path at every size; the window size c is chosen from
the number of points and does not change the result.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..fields import limb
from ..fields.host import Fp
from ..kernels import msm as kmsm
from . import device as cdev
from .host import AffinePoint, msm_host
from .specs import CurveSpec


def window_size(n: int) -> int:
    """Signed window width for n points: about log2(n) - 4, in [2, 16]."""
    return max(2, min(16, n.bit_length() - 5))


def num_windows(curve: CurveSpec, c: int) -> int:
    return -(-curve.scalar.num_bits // c) + 1


def signed_digits(scalars: torch.Tensor, c: int, windows: int):
    """Canonical scalars int32[N, 8] -> (bucket int64[W, N], negative bool[W, N]).

    d_w = ((s >> c*w) & (2^c - 1)) + carry, taken as d_w - 2^c with a carry
    of 1 into the next window when d_w >= 2^(c-1)."""
    n = scalars.shape[0]
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    v = torch.cat([v, torch.zeros((n, 2), dtype=torch.int64, device=v.device)], 1)
    mask = (1 << c) - 1
    half = 1 << (c - 1)
    carry = torch.zeros(n, dtype=torch.int64, device=v.device)
    buckets, negs = [], []
    for w in range(windows):
        off = w * c
        li, sh = off // 32, off % 32
        d = v[:, li] >> sh
        if sh + c > 32:
            d = d | (v[:, li + 1] << (32 - sh))
        d = (d & mask) + carry
        carry = (d >= half).to(torch.int64)
        d = d - (carry << c)
        buckets.append(d.abs())
        negs.append(d < 0)
    return torch.stack(buckets), torch.stack(negs)


def msm_entries(scalars: torch.Tensor, c: int, windows: int):
    """Non-zero (window, bucket) entries of the recoded scalars, sorted by
    key: (keys int32[M], src int32[M] = 2 * point + sign, keys per window)."""
    n = scalars.shape[0]
    nb = (1 << (c - 1)) + 1
    bucket, neg = signed_digits(scalars, c, windows)
    dev = bucket.device
    keys = bucket + torch.arange(windows, device=dev).unsqueeze(1) * nb
    src = 2 * torch.arange(n, device=dev).expand(windows, n) + neg.to(torch.int64)
    live = bucket != 0
    keys, order = torch.sort(keys[live])
    src = src[live][order]
    return keys.to(torch.int32).contiguous(), src.to(torch.int32).contiguous(), nb


def combine_windows(curve: CurveSpec, window_sums: torch.Tensor, c: int) -> AffinePoint:
    """sum_w 2^(c*w) * window_w on the host (c doublings per window)."""
    acc = AffinePoint.identity(curve)
    for wp in reversed(cdev.jac_to_host(curve, window_sums)):
        for _ in range(c):
            acc = acc.double()
        acc = acc + wp
    return acc


def variable_base_msm(
    curve: CurveSpec, scalars: torch.Tensor, bases: torch.Tensor
) -> AffinePoint:
    """sum_i scalars[i] * bases[i].

    scalars: canonical (not Montgomery) int32[N, 8]; bases: affine
    int32[N, 2, 8] on the same device."""
    n = scalars.shape[0]
    assert bases.shape[0] == n, (bases.shape, scalars.shape)
    if n == 0:
        return AffinePoint.identity(curve)
    c = window_size(n)
    w = num_windows(curve, c)
    keys, src, nb = msm_entries(scalars, c, w)
    buckets = kmsm.bucket_sums(curve, bases.contiguous(), keys, src, w * nb)
    windows = kmsm.window_sums(curve, buckets.reshape(w, nb, 3, 8))
    return combine_windows(curve, windows, c)


def msm_affine(scalars: Sequence[Fp], points: Sequence[AffinePoint]) -> AffinePoint:
    """Verifier-side MSM over host points (reference msm_affine): a few
    points, summed on the host."""
    assert len(scalars) == len(points)
    return msm_host(scalars, points)


def fixed_base_msm(
    curve: CurveSpec, base: AffinePoint, scalars: torch.Tensor, c: int = 8
) -> torch.Tensor:
    """[base * s_i] for Montgomery scalars int32[N, 8] -> affine int32[N, 2, 8].

    A host window table table[w][d] = base * (d << c*w) (msm.rs:16-48), then
    one complete mixed addition per window over the whole batch, in chunks,
    and one batched normalisation to affine."""
    spec = curve.scalar
    dev = scalars.device
    windows = -(-spec.num_bits // c)
    table: List[AffinePoint] = []
    for w in range(windows):
        step = base.scalar_mul(1 << (c * w))
        acc = AffinePoint.identity(curve)
        for _ in range(1 << c):
            table.append(acc)
            acc = acc + step
    tab = cdev.affine_from_host(curve, table, dev)  # [W * 2^c, 2, 8]
    canon = limb.from_mont(spec, scalars)
    v = canon.to(torch.int64) & 0xFFFFFFFF
    v = torch.cat([v, torch.zeros_like(v[:, :1])], 1)
    mask = (1 << c) - 1
    outs = []
    chunk = 1 << 20
    for lo in range(0, scalars.shape[0], chunk):
        vc = v[lo: lo + chunk]
        zero = torch.zeros((16, vc.shape[0]), dtype=torch.int64, device=dev)
        acc = (zero, zero, zero)
        for w in range(windows):
            off = w * c
            li, sh = off // 32, off % 32
            d = vc[:, li] >> sh
            if sh + c > 32:
                d = d | (vc[:, li + 1] << (32 - sh))
            d = (d & mask) + (w << c)
            x, y, inf = cdev.unpack_affine(tab[d])
            acc = cdev.jmadd(curve, acc, x, y, inf)
        outs.append(cdev.jac_to_affine(curve, acc))
    return torch.cat(outs, 0)
