"""Jacobian point formulas on torch tensors (port of the ``_jdbl_soa``,
``_jmadd_soa`` and ``_jadd_soa`` formulas of plonkish_tpu/curves/device.py).

A point batch is a tuple ``(x, y, z)`` of ``int64[16, N]`` Montgomery digit
tensors over the base field (see ``fields.limb``), Jacobian coordinates
(x = X/Z^2, y = Y/Z^3), the identity has ``Z = 0``.  Affine inputs are
``(x, y, inf)``.  Every formula handles its exceptional cases by selection:
identity operands, equal points (doubling) and opposite points.  The CUDA
header ``csrc/curve.cuh`` computes the same formulas one point per thread.

Storage on a device is ``int32[..., 3, 8]`` (Jacobian) or ``int32[..., 2, 8]``
(affine, identity written as (0, 0), which is not on a curve with b != 0).
``identity``, ``padd``, ``pdbl`` and ``scalar_mul_const`` work on Jacobian
storage, for BN254 G1 and Grumpkin G1 alike (both have a = 0); they are the
plain version of the IPA base fold (``kernels/ipa.py``).
"""

from __future__ import annotations

import functools
from typing import List

import torch

from ..fields import limb
from ..fields.host import Fp
from .host import AffinePoint
from .specs import CurveSpec


class _F:
    """Base-field digit ops bound to one curve and device."""

    def __init__(self, curve: CurveSpec, device):
        self.c = limb._consts(curve.base, device)

    def mul(self, a, b):
        return limb.d_mul(a, b, self.c)

    def sqr(self, a):
        return limb.d_mul(a, a, self.c)

    def add(self, a, b):
        return limb.d_add(a, b, self.c)

    def sub(self, a, b):
        return limb.d_sub(a, b, self.c)


def _cat(*vs):
    return torch.cat(vs, dim=1)


def _split(v, parts):
    return v.tensor_split(parts, dim=1)


def jdbl(curve: CurveSpec, p):
    """Jacobian doubling, a = 0 (dbl-2009-l).  Independent products and sums
    go through one call on the stacked operands: a chain of doublings (the
    MSM's window combine) is bound by the number of calls, not their width."""
    x1, y1, z1 = p
    f = _F(curve, x1.device)
    a, b, z3 = _split(f.mul(_cat(x1, y1, y1), _cat(x1, y1, z1)), 3)
    xb, a2 = _split(f.add(_cat(x1, a), _cat(b, a)), 2)
    c, d = _split(f.sqr(_cat(b, xb)), 2)
    e = f.add(a2, a)
    d = f.sub(f.sub(d, a), c)
    d, c8, z3 = _split(f.add(_cat(d, c, z3), _cat(d, c, z3)), 3)
    d2, c8 = _split(f.add(_cat(d, c8), _cat(d, c8)), 2)
    x3 = f.sub(f.sqr(e), d2)
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
    return (x3, y3, z3)


def _doubled(curve: CurveSpec, p, dbl):
    """2p where `dbl` selects it, computed only when some point of the batch
    needs it.  On the card the check is one device read per call: the
    kernels' paths never call this, and ``fixed_base_msm`` (setup) reads
    once per window and chunk, 32 times for an SRS of 2^20 points.
    Computing the doubling every time instead made the KZG setup at k = 20
    about 50 % slower on an H100 (PERF.md): random batches almost never
    need it."""
    if bool(dbl.any()):
        return jdbl(curve, p)
    return p


def jmadd(curve: CurveSpec, p, x2, y2, inf2):
    """Jacobian + affine (madd-2007-bl) with every case selected."""
    x1, y1, z1 = p
    f = _F(curve, x1.device)
    z1z1 = f.sqr(z1)
    u2 = f.mul(x2, z1z1)
    s2 = f.mul(y2, f.mul(z1, z1z1))
    h = f.sub(u2, x1)
    hh = f.sqr(h)
    i4 = f.add(hh, hh)
    i4 = f.add(i4, i4)
    j = f.mul(h, i4)
    r = f.sub(s2, y1)
    r = f.add(r, r)
    v = f.mul(x1, i4)
    x3 = f.sub(f.sub(f.sqr(r), j), f.add(v, v))
    yj = f.mul(y1, j)
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(yj, yj))
    zh = f.add(z1, h)
    z3 = f.sub(f.sub(f.sqr(zh), z1z1), hh)

    p1_inf = limb.d_is_zero(z1)
    h_zero = limb.d_is_zero(h)
    r_zero = limb.d_is_zero(r)
    dbl = h_zero & r_zero & ~p1_inf & ~inf2
    opposite = h_zero & ~r_zero
    dx, dy, dz = _doubled(curve, p, dbl)
    one = f.c["one"].expand_as(x2)
    zero = torch.zeros_like(x2)

    def pick(v3, dv, av, pv):
        o = torch.where(opposite, zero, v3)
        o = torch.where(dbl, dv, o)
        o = torch.where(p1_inf, av, o)
        return torch.where(inf2, pv, o)

    return (pick(x3, dx, x2, x1), pick(y3, dy, y2, y1), pick(z3, dz, one, z1))


def jadd(curve: CurveSpec, p, q):
    """Full Jacobian addition (add-2007-bl) with every case selected."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    f = _F(curve, x1.device)
    z1z1 = f.sqr(z1)
    z2z2 = f.sqr(z2)
    u1 = f.mul(x1, z2z2)
    u2 = f.mul(x2, z1z1)
    s1 = f.mul(y1, f.mul(z2, z2z2))
    s2 = f.mul(y2, f.mul(z1, z1z1))
    h = f.sub(u2, u1)
    h2 = f.add(h, h)
    i = f.sqr(h2)
    j = f.mul(h, i)
    r = f.sub(s2, s1)
    r = f.add(r, r)
    v = f.mul(u1, i)
    x3 = f.sub(f.sub(f.sqr(r), j), f.add(v, v))
    sj = f.mul(s1, j)
    y3 = f.sub(f.mul(r, f.sub(v, x3)), f.add(sj, sj))
    zz = f.add(z1, z2)
    z3 = f.mul(f.sub(f.sub(f.sqr(zz), z1z1), z2z2), h)

    p1_inf = limb.d_is_zero(z1)
    p2_inf = limb.d_is_zero(z2)
    h_zero = limb.d_is_zero(h)
    r_zero = limb.d_is_zero(r)
    both = ~(p1_inf | p2_inf)
    dbl = both & h_zero & r_zero
    opposite = both & h_zero & ~r_zero
    dx, dy, dz = _doubled(curve, p, dbl)
    zero = torch.zeros_like(x1)

    def pick(v3, dv, qv, pv):
        o = torch.where(opposite, zero, v3)
        o = torch.where(dbl, dv, o)
        o = torch.where(p1_inf, qv, o)
        return torch.where(p2_inf, pv, o)

    return (pick(x3, dx, x2, x1), pick(y3, dy, y2, y1), pick(z3, dz, z2, z1))


# ---------------------------------------------------------------------------
# Layout conversions
# ---------------------------------------------------------------------------

def unpack_jac(t: torch.Tensor):
    """int32[N, 3, 8] -> (x, y, z) digit tensors."""
    return tuple(limb.unpack(t[:, i]) for i in range(3))


def pack_jac(p) -> torch.Tensor:
    return torch.stack([limb.pack(v) for v in p], dim=1)


def unpack_affine(t: torch.Tensor):
    """int32[N, 2, 8] -> (x, y, inf)."""
    x, y = limb.unpack(t[:, 0]), limb.unpack(t[:, 1])
    return x, y, limb.d_is_zero(x) & limb.d_is_zero(y)


def affine_to_jac(curve: CurveSpec, x, y, inf):
    one = limb._consts(curve.base, x.device)["one"].expand_as(x)
    z = torch.where(inf, torch.zeros_like(x), one)
    return (x, y, z)


def jac_to_affine(curve: CurveSpec, p) -> torch.Tensor:
    """Jacobian digits -> int32[N, 2, 8] affine storage (batch inversion)."""
    x, y, z = p
    spec = curve.base
    c = limb._consts(spec, x.device)
    zi = limb.d_batch_inv(z, spec)
    zi2 = limb.d_mul(zi, zi, c)
    ax = limb.d_mul(x, zi2, c)
    ay = limb.d_mul(y, limb.d_mul(zi2, zi, c), c)
    return torch.stack([limb.pack(ax), limb.pack(ay)], dim=1)


def affine_to_host(curve: CurveSpec, t: torch.Tensor) -> List[AffinePoint]:
    """int32[N, 2, 8] affine storage -> host AffinePoints."""
    spec = curve.base
    xs = limb.to_canonical_ints(spec, t[:, 0])
    ys = limb.to_canonical_ints(spec, t[:, 1])
    return [
        AffinePoint.identity(curve) if x == 0 and y == 0
        else AffinePoint(curve, Fp(x, spec), Fp(y, spec))
        for x, y in zip(xs, ys)
    ]


def affine_from_host(curve: CurveSpec, points, device) -> torch.Tensor:
    """Host AffinePoints -> int32[N, 2, 8] affine storage."""
    spec = curve.base
    xs = [0 if p.is_identity() else int(p.x) for p in points]
    ys = [0 if p.is_identity() else int(p.y) for p in points]
    x = limb.from_canonical_ints(spec, xs, device)
    y = limb.from_canonical_ints(spec, ys, device)
    return torch.stack([x, y], dim=1)


def jac_to_host(curve: CurveSpec, t: torch.Tensor) -> List[AffinePoint]:
    """int32[N, 3, 8] Jacobian storage -> host AffinePoints (one read of the
    tensor, then Python integers: the Montgomery factor and the inversions)."""
    spec = curve.base
    p = spec.p
    r_inv = pow(1 << 256, -1, p)
    vals = limb.to_ints(t.reshape(-1, 8))
    out = []
    for i in range(0, len(vals), 3):
        x, y, z = (v * r_inv % p for v in vals[i: i + 3])
        if z == 0:
            out.append(AffinePoint.identity(curve))
            continue
        zi = pow(z, -1, p)
        zi2 = zi * zi % p
        out.append(
            AffinePoint(curve, Fp(x * zi2 % p, spec), Fp(y * zi2 % p * zi % p, spec))
        )
    return out


# ---------------------------------------------------------------------------
# Point batches in storage form (counterparts of the reference's identity,
# padd, pdbl and scalar_mul_const, curves/device.py:26-591)
# ---------------------------------------------------------------------------

def identity(curve: CurveSpec, shape=(), device="cpu") -> torch.Tensor:
    """The identity as Jacobian storage int32[*shape, 3, 8] (Z = 0)."""
    return torch.zeros((*shape, 3, 8), dtype=torch.int32, device=device)


def padd(curve: CurveSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q for Jacobian storage batches int32[N, 3, 8]."""
    return pack_jac(jadd(curve, unpack_jac(p), unpack_jac(q)))


def pdbl(curve: CurveSpec, p: torch.Tensor) -> torch.Tensor:
    """2p for a Jacobian storage batch int32[N, 3, 8]."""
    return pack_jac(jdbl(curve, unpack_jac(p)))


@functools.lru_cache(maxsize=None)
def _endomorphism(curve: CurveSpec):
    """(beta, lambda, short lattice basis) of the curve's GLV endomorphism
    (x, y) -> (beta * x, y) = lambda * (x, y), which every a = 0 curve over
    a field with p = 1 mod 3 has: beta a cube root of unity of the base
    field, lambda one of the scalar field, paired on the generator."""
    p, n = curve.base.p, curve.scalar.p
    beta = next(b for b in (pow(h, (p - 1) // 3, p) for h in range(2, 100)) if b != 1)
    lam = next(v for v in (pow(h, (n - 1) // 3, n) for h in range(2, 100)) if v != 1)
    g = AffinePoint.generator(curve)
    if g.scalar_mul(lam) != AffinePoint(curve, g.x * Fp(beta, curve.base), g.y):
        beta = beta * beta % p
    # extended Euclid on (n, lambda) down to sqrt(n) (GLV's lattice basis)
    r0, r1, t0, t1 = n, lam, 0, 1
    while r1 * r1 >= n:
        q = r0 // r1
        r0, r1, t0, t1 = r1, r0 - q * r1, t1, t0 - q * t1
    q = r0 // r1
    r2, t2 = r0 - q * r1, t0 - q * t1
    v1 = (r1, -t1)
    v2 = (r0, -t0) if r0 * r0 + t0 * t0 <= r2 * r2 + t2 * t2 else (r2, -t2)
    return beta, lam, v1, v2


def _glv_split(curve: CurveSpec, k: int):
    """(k1, k2) of about half the bits each with k = k1 + k2 * lambda mod n."""
    n = curve.scalar.p
    _, lam, (a1, b1), (a2, b2) = _endomorphism(curve)
    c1 = (b2 * k + n // 2) // n
    c2 = (-b1 * k + n // 2) // n
    k1, k2 = k - c1 * a1 - c2 * a2, -c1 * b1 - c2 * b2
    assert (k1 + k2 * lam - k) % n == 0
    return k1, k2


def scalar_mul_const(curve: CurveSpec, points: torch.Tensor, k: int) -> torch.Tensor:
    """k * P for every point, with one host-known scalar k.  points: Jacobian
    storage int32[N, 3, 8], or affine int32[N, 2, 8] (then the additions of
    P are mixed); the result is Jacobian storage.

    k is split by the curve's endomorphism into k1 + k2 * lambda of about
    128 bits each, and k1 * P + k2 * phi(P) is one double-and-add over both
    halves at once (Shamir): half the doublings of a plain ladder."""
    k = int(k) % curve.scalar.p
    affine = points.shape[-2] == 2
    x, y, zi = unpack_affine(points) if affine else unpack_jac(points)
    c = limb._consts(curve.base, x.device)
    beta = limb.d_const(curve.base, _endomorphism(curve)[0], x.device)
    k1, k2 = _glv_split(curve, k)
    p1 = (x, limb.d_neg(y, c) if k1 < 0 else y, zi)
    p2 = (limb.d_mul(x, beta, c), limb.d_neg(y, c) if k2 < 0 else y, zi)
    k1, k2 = abs(k1), abs(k2)
    if affine:
        both = jmadd(curve, affine_to_jac(curve, *p1), *p2)
        add = lambda acc, q: jmadd(curve, acc, *q)  # noqa: E731
    else:
        both = jadd(curve, p1, p2)
        add = lambda acc, q: jadd(curve, acc, q)  # noqa: E731
    zero = torch.zeros_like(x)
    acc = (zero, zero, zero)
    for i in reversed(range(max(k1.bit_length(), k2.bit_length()))):
        acc = jdbl(curve, acc)
        b1, b2 = (k1 >> i) & 1, (k2 >> i) & 1
        if b1 and b2:
            acc = jadd(curve, acc, both)
        elif b1:
            acc = add(acc, p1)
        elif b2:
            acc = add(acc, p2)
    return pack_jac(acc)


def affine_to_jac_storage(curve: CurveSpec, t: torch.Tensor) -> torch.Tensor:
    """int32[N, 2, 8] affine storage -> int32[N, 3, 8] Jacobian storage."""
    return pack_jac(affine_to_jac(curve, *unpack_affine(t)))
