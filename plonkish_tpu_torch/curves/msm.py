"""Multi-scalar multiplication (port of plonkish_tpu/curves/msm.py).

Pippenger with signed windows, shaped for a card with atomics and a fast sort
rather than for the TPU's lane-private buckets:

1. every scalar is recoded on the device into signed c-bit digits, all
   windows in one pass, giving B = 2^(c-1) + 1 buckets per window (bucket 0
   unused);
2. every (window, point) digit is sorted by key, so each bucket's points are
   one contiguous run; zero digits take a sentinel key that sorts last, so
   nothing is compacted;
3. K1 (``kernels.msm.bucket_sums``) reduces each run with complete mixed
   additions, so repeated points, P + (-P) and the identity come out right
   and no random blind is needed;
4. K2 (``kernels.msm.window_sums``) forms sum_b b * B_b per window and
   combines the windows, c doublings each, into one Jacobian point.

On a CUDA tensor all of this is enqueued without a read from the device: the
sizes of every array and launch follow from N alone.  Only the one result
point is read back and made affine on the host (one inversion).  Every MSM
takes this path at every size; the window size c is chosen from the number
of points and does not change the result.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import parallel
from ..fields import limb
from ..fields.host import Fp
from ..kernels import msm as kmsm
from ..utils import timer
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

    d_w = ((s >> c*w) & (2^c - 1)) + carry_w, taken as d_w - 2^c with a carry
    of 1 into the next window when d_w >= 2^(c-1).  All windows at once: a
    raw digit >= 2^(c-1) makes a carry, one equal to 2^(c-1) - 1 passes an
    incoming carry on, any other stops it, so the carry out of window w is
    the making bit of the last window up to w that does not pass carries on
    (a running maximum over the window axis)."""
    n = scalars.shape[0]
    dev = scalars.device
    v = scalars.to(torch.int64) & 0xFFFFFFFF
    v = torch.cat([v, torch.zeros((n, 2), dtype=torch.int64, device=dev)], 1).T
    half = 1 << (c - 1)
    off = torch.arange(windows, device=dev) * c
    li, sh = off // 32, (off % 32).unsqueeze(1)
    raw = ((v[li] >> sh) | (v[li + 1] << (32 - sh))) & ((1 << c) - 1)
    window = torch.arange(windows, device=dev).unsqueeze(1).expand(windows, n)
    stop = torch.cummax(window.masked_fill(raw == half - 1, -1), 0).values
    carry = (stop >= 0) & (raw >= half).gather(0, stop.clamp(min=0))
    carry_in = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]])
    d = raw + carry_in - (carry.to(torch.int64) << c)
    return d.abs(), d < 0


def msm_entries(scalars: torch.Tensor, c: int, windows: int):
    """Every (window, point) digit of the recoded scalars, sorted by key:
    (keys int32[W * N], src int32[W * N] = 2 * point + sign, buckets per
    window B).  A non-zero digit of window w in bucket b has key w * B + b; a
    zero digit has the sentinel key W * B, which sorts after every real key."""
    n = scalars.shape[0]
    nb = (1 << (c - 1)) + 1
    bucket, neg = signed_digits(scalars, c, windows)
    dev = bucket.device
    keys = bucket + torch.arange(windows, device=dev).unsqueeze(1) * nb
    keys = keys.masked_fill(bucket == 0, windows * nb).to(torch.int32)
    src = 2 * torch.arange(n, device=dev, dtype=torch.int32) + neg.to(torch.int32)
    keys, order = torch.sort(keys.reshape(-1))
    src = src.reshape(-1)[order]
    return keys.contiguous(), src.contiguous(), nb


def msm_jacobian(curve: CurveSpec, scalars: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """sum_i scalars[i] * bases[i] as one Jacobian point int32[3, 8] on the
    scalars' device; on a card, enqueued without a read from it."""
    n = scalars.shape[0]
    assert bases.shape[0] == n, (bases.shape, scalars.shape)
    if n == 0:
        return limb.zeros((3,), scalars.device)
    c = window_size(n)
    w = num_windows(curve, c)
    k, dev = (n - 1).bit_length(), scalars.device
    with timer.span(f"msm_recode-{k}", sync=False, device=dev):
        keys, src, nb = msm_entries(scalars, c, w)
    with timer.span(f"msm_bucket_sums-{k}", sync=False, device=dev):
        buckets = kmsm.bucket_sums(curve, bases.contiguous(), keys, src, w * nb)
    with timer.span(f"msm_window_sums-{k}", sync=False, device=dev):
        return kmsm.window_sums(curve, buckets.reshape(w, nb, 3, 8), c)


def variable_base_msm(
    curve: CurveSpec, scalars: torch.Tensor, bases: torch.Tensor
) -> AffinePoint:
    """sum_i scalars[i] * bases[i].

    scalars: canonical (not Montgomery) int32[N, 8]; bases: affine
    int32[N, 2, 8] on the same device.  The one result point is the only
    read from the device.  Under a mesh of w > 1 ranks, with N divisible
    by w and N / w >= 4, the points are split over the ranks
    (``parallel.sharded.sharded_msm``), the reference's rule
    (curves/msm.py:583-593); otherwise every rank runs the whole MSM."""
    n = scalars.shape[0]
    mesh = parallel.get_mesh()
    if mesh is not None and mesh.world > 1 and n % mesh.world == 0 and n // mesh.world >= 4:
        from ..parallel.sharded import sharded_msm

        return sharded_msm(curve, mesh, scalars, bases)
    jac = msm_jacobian(curve, scalars, bases)
    with timer.span(f"msm_readback-{(n - 1).bit_length()}", sync=False, device=jac.device):
        point = jac.cpu()
        timer.device_read(jac)
        return cdev.jac_to_host(curve, point[None])[0]


def msm_affine(scalars: Sequence[Fp], points: Sequence[AffinePoint], device=None) -> AffinePoint:
    """Verifier-side MSM over host points (reference msm_affine,
    curves/msm.py:677-690): summed on the host, unless a device is given and
    there are 16 points or more, when they go through variable_base_msm
    there (Hyrax's verifier combines one commitment per row)."""
    assert len(scalars) == len(points)
    if device is None or len(points) < 16:
        return msm_host(scalars, points)
    curve = points[0].curve
    bases = cdev.affine_from_host(curve, points, device)
    return variable_base_msm(curve, limb.from_ints([int(s) for s in scalars], device), bases)


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
