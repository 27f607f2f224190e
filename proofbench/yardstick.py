"""The benchmark's frozen yardstick: the card's peaks and the least work of
the operations whose roofline share it reports.

Unit of work: one 32-bit integer multiply-add.  A Montgomery product of two
BN254 elements (eight 32-bit limbs) takes the 64 partial products of a * b
and the 64 of the reduction, 32 x 32 -> 64 bits, each two multiply-adds (the
low and the high word): 256.  Additions, carries and selects are not counted.

Peaks of one NVIDIA H100 SXM: the published HBM rate, and the integer rate
assumed from the published design (132 SMs x 64 INT32 lanes x 1.98 GHz, one
multiply-add a lane a cycle).  Both are fixed numbers here, never measured
in the run, so the yardstick does not move with the card's state.

The counts are functions of a call's shape alone, and each is at most what
any method named below needs, so a leaner design still reads under 100 %.
"""

from __future__ import annotations

import math

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "imad_per_s": 132 * 64 * 1.98e9,  # 16.727e12
}
PRODUCT_IMAD = 256
FE_BYTES = 32
AFFINE_POINT_BYTES = 64
# A batch-affine addition: Montgomery's trick shares one inversion over the
# batch at 3 products an element, then the slope, its square and y3: 6.
AFFINE_ADD_PRODUCTS = 6


def msm_least_work(n: int, scalar_bits: int = 254, glv: bool = True):
    """(multiply-adds, bytes) that one MSM of n points and full-width
    scalars needs at least, by the leanest of the methods named: scalars
    split by the curve's endomorphism into two halves of ceil(bits / 2) bits
    (GLV; BN254 G1 has one), signed digits of c bits (2^(c-1) buckets a
    window), every bucket addition and every addition of the bucket
    reduction (two a bucket) batch-affine, the window width c that needs the
    fewest additions, one product a point for the endomorphism's image.  The
    combine's doublings, the scalar split and the inversions of the batches
    are left out.  Bytes: the points (affine, 64 B) and the scalars (32 B),
    each read once."""
    points = 2 * n if glv else n
    bits = math.ceil(scalar_bits / 2) if glv else scalar_bits
    best = None
    for c in range(1, 33):
        windows = math.ceil(bits / c)
        buckets = windows * (1 << (c - 1))
        additions = points * windows - min(buckets, points * windows) + 2 * buckets
        if best is None or additions < best:
            best = additions
    products = best * AFFINE_ADD_PRODUCTS + (n if glv else 0)
    return products * PRODUCT_IMAD, n * (AFFINE_POINT_BYTES + FE_BYTES)


def least_seconds(work) -> float:
    """The least time the card could take for (multiply-adds, bytes)."""
    ops, nbytes = work
    return max(ops / PEAKS["imad_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])
