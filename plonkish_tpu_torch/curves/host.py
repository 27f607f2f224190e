# Copied from plonkish_tpu/curves/host.py; imports resolve inside plonkish_tpu_torch.
"""Host-side elliptic curve arithmetic (Python ints, Jacobian coordinates).

Used by verifiers, setup, and as the gold reference for device kernels.
Scale is O(k + #openings) points — host arithmetic is fine.
"""

from __future__ import annotations

from ..fields.host import Fp
from .specs import CurveSpec


class AffinePoint:
    __slots__ = ("curve", "x", "y", "infinity")

    def __init__(self, curve: CurveSpec, x: Fp, y: Fp, infinity: bool = False):
        self.curve = curve
        self.x = x
        self.y = y
        self.infinity = infinity

    # -- constructors --
    @classmethod
    def identity(cls, curve: CurveSpec) -> "AffinePoint":
        zero = Fp.zero(curve.base)
        return cls(curve, zero, zero, infinity=True)

    @classmethod
    def generator(cls, curve: CurveSpec) -> "AffinePoint":
        return cls(curve, Fp(curve.gen_x, curve.base), Fp(curve.gen_y, curve.base))

    @classmethod
    def from_xy(cls, curve: CurveSpec, x: Fp, y: Fp) -> "AffinePoint":
        p = cls(curve, x, y)
        if not p.is_on_curve():
            raise ValueError("Invalid elliptic curve point encoding")
        return p

    def is_identity(self) -> bool:
        return self.infinity

    def is_on_curve(self) -> bool:
        if self.infinity:
            return True
        return self.y * self.y == self.x * self.x * self.x + Fp(
            self.curve.b, self.curve.base
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, AffinePoint):
            return NotImplemented
        if self.infinity or other.infinity:
            return self.infinity == other.infinity
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash((self.infinity, int(self.x), int(self.y)))

    def __repr__(self):
        if self.infinity:
            return "AffinePoint(inf)"
        return f"AffinePoint(0x{int(self.x):x}, 0x{int(self.y):x})"

    # -- group law (affine with inversions; host-scale only) --
    def __neg__(self) -> "AffinePoint":
        if self.infinity:
            return self
        return AffinePoint(self.curve, self.x, -self.y)

    def __add__(self, other: "AffinePoint") -> "AffinePoint":
        if self.infinity:
            return other
        if other.infinity:
            return self
        if self.x == other.x:
            if self.y == -other.y:
                return AffinePoint.identity(self.curve)
            # doubling
            lam = (self.x * self.x * 3) * (self.y.double()).inv()
        else:
            lam = (other.y - self.y) * (other.x - self.x).inv()
        x3 = lam * lam - self.x - other.x
        y3 = lam * (self.x - x3) - self.y
        return AffinePoint(self.curve, x3, y3)

    def __sub__(self, other):
        return self + (-other)

    def double(self) -> "AffinePoint":
        return self + self

    def scalar_mul(self, k: int) -> "AffinePoint":
        k = int(k) % self.curve.scalar.p
        acc = AffinePoint.identity(self.curve)
        add = self
        while k:
            if k & 1:
                acc = acc + add
            add = add + add
            k >>= 1
        return acc

    def __mul__(self, k):
        return self.scalar_mul(int(k))

    __rmul__ = __mul__


def msm_host(scalars, points) -> AffinePoint:
    """Naive host MSM (gold reference for tests)."""
    assert len(scalars) == len(points)
    curve = points[0].curve
    acc = AffinePoint.identity(curve)
    for s, pt in zip(scalars, points):
        acc = acc + pt.scalar_mul(int(s))
    return acc
