"""BN254 G1 on the host for the benchmark's reference: y^2 = x^3 + 3 over
Fq, affine points as (x, y) int pairs and None for the identity (the group
law of plonkish_tpu_torch/curves/host.py, written on plain ints)."""

from __future__ import annotations

from .field import BN254_Q, BN254_R, FQ, FR


class _Curve:
    def __init__(self, base, scalar, b: int, gen):
        self.base, self.scalar, self.b, self.gen = base, scalar, b, gen
        self.p = base.p

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return (y * y - x * x * x - self.b) % self.p == 0

    def checked(self, x: int, y: int):
        if not self.on_curve((x, y)):
            raise ValueError("Invalid elliptic curve point encoding")
        return (x, y)

    def neg(self, a):
        return None if a is None else (a[0], (-a[1]) % self.p)

    def add(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        p = self.p
        (x1, y1), (x2, y2) = a, b
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return None
            lam = 3 * x1 * x1 * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        return (x3, (lam * (x1 - x3) - y1) % p)

    def mul(self, a, k: int):
        k %= self.scalar.p
        acc, add = None, a
        while k:
            if k & 1:
                acc = self.add(acc, add)
            add = self.add(add, add)
            k >>= 1
        return acc

    def msm(self, scalars, points):
        acc = None
        for s, pt in zip(scalars, points):
            acc = self.add(acc, self.mul(pt, int(s)))
        return acc


G1 = _Curve(FQ, FR, 3, (1, 2))
assert G1.p == BN254_Q and G1.scalar.p == BN254_R
