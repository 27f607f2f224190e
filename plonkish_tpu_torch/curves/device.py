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
"""

from __future__ import annotations

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


def jdbl(curve: CurveSpec, p):
    """Jacobian doubling, a = 0 (dbl-2009-l)."""
    x1, y1, z1 = p
    f = _F(curve, x1.device)
    a = f.sqr(x1)
    b = f.sqr(y1)
    c = f.sqr(b)
    d = f.sqr(f.add(x1, b))
    d = f.sub(f.sub(d, a), c)
    d = f.add(d, d)
    e = f.add(f.add(a, a), a)
    x3 = f.sub(f.sqr(e), f.add(d, d))
    c8 = f.add(c, c)
    c8 = f.add(c8, c8)
    c8 = f.add(c8, c8)
    y3 = f.sub(f.mul(e, f.sub(d, x3)), c8)
    z3 = f.mul(y1, z1)
    z3 = f.add(z3, z3)
    return (x3, y3, z3)


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
    dbl = h_zero & r_zero
    opposite = h_zero & ~r_zero
    dx, dy, dz = jdbl(curve, p)
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
    dx, dy, dz = jdbl(curve, p)
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
    """int32[N, 3, 8] Jacobian storage -> host AffinePoints (host inversions)."""
    spec = curve.base
    p = spec.p
    xs = limb.to_canonical_ints(spec, t[:, 0])
    ys = limb.to_canonical_ints(spec, t[:, 1])
    zs = limb.to_canonical_ints(spec, t[:, 2])
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(AffinePoint.identity(curve))
            continue
        zi = pow(z, -1, p)
        zi2 = zi * zi % p
        out.append(
            AffinePoint(curve, Fp(x * zi2 % p, spec), Fp(y * zi2 % p * zi % p, spec))
        )
    return out
