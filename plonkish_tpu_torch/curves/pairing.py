# Copied from plonkish_tpu/curves/pairing.py; imports resolve inside plonkish_tpu_torch.
"""BN254 pairing on host (verifier-only path).

The reference gets pairings from halo2_curves (`MultiMillerLoop`,
util/arithmetic.rs:25-34); proofs never contain pairing outputs, so any
consistent nondegenerate bilinear pairing validates KZG openings.  This is a
straightforward optimal-ate implementation over the Fq2/Fq6/Fq12 tower with
affine Miller-loop arithmetic embedded in Fq12 — O(100) tower ops per pairing,
negligible next to proving work.

Tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - (9+u)), Fq12 = Fq6[w]/(w^2 - v).
G2 lives on the D-twist y^2 = x^3 + 3/(9+u); ψ(x,y) = (x·w^2, y·w^3).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

from ..fields.host import Fp
from ..fields.spec import BN254_FQ, BN254_FR
from .host import AffinePoint
from .specs import BN254_G1

P = BN254_FQ.p
BN_X = 4965661367192848881  # BN parameter
ATE_LOOP = 6 * BN_X + 2


# ---------------------------------------------------------------------------
# Tower fields (immutable tuples of Python ints mod P)
# ---------------------------------------------------------------------------

class Fq2(tuple):
    """a + b·u with u^2 = -1."""

    def __new__(cls, a: int, b: int = 0):
        return super().__new__(cls, (a % P, b % P))

    @property
    def a(self):
        return self[0]

    @property
    def b(self):
        return self[1]

    def __add__(self, o):
        return Fq2(self[0] + o[0], self[1] + o[1])

    def __sub__(self, o):
        return Fq2(self[0] - o[0], self[1] - o[1])

    def __neg__(self):
        return Fq2(-self[0], -self[1])

    def __mul__(self, o):
        if isinstance(o, int):
            return Fq2(self[0] * o, self[1] * o)
        a0, a1 = self
        b0, b1 = o
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    def conj(self):
        return Fq2(self[0], -self[1])

    def inv(self):
        norm = (self[0] * self[0] + self[1] * self[1]) % P
        ninv = pow(norm, -1, P)
        return Fq2(self[0] * ninv, -self[1] * ninv)

    def pow(self, e: int):
        result = FQ2_ONE
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def is_zero(self):
        return self[0] == 0 and self[1] == 0


FQ2_ZERO = Fq2(0, 0)
FQ2_ONE = Fq2(1, 0)
XI = Fq2(9, 1)  # nonresidue for the sextic extension


class Fq6(tuple):
    """c0 + c1·v + c2·v^2 with v^3 = XI (coords in Fq2)."""

    def __new__(cls, c0: Fq2, c1: Fq2, c2: Fq2):
        return super().__new__(cls, (c0, c1, c2))

    def __add__(self, o):
        return Fq6(self[0] + o[0], self[1] + o[1], self[2] + o[2])

    def __sub__(self, o):
        return Fq6(self[0] - o[0], self[1] - o[1], self[2] - o[2])

    def __neg__(self):
        return Fq6(-self[0], -self[1], -self[2])

    def __mul__(self, o):
        a0, a1, a2 = self
        b0, b1, b2 = o
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = t0 + ((a1 + a2) * (b1 + b2) - t1 - t2) * XI
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_by_v(self):
        return Fq6(self[2] * XI, self[0], self[1])

    def inv(self):
        a0, a1, a2 = self
        c0 = a0 * a0 - a1 * a2 * XI
        c1 = a2 * a2 * XI - a0 * a1
        c2 = a1 * a1 - a0 * a2
        t = (a0 * c0 + (a2 * c1 + a1 * c2) * XI).inv()
        return Fq6(c0 * t, c1 * t, c2 * t)

    def is_zero(self):
        return all(c.is_zero() for c in self)


FQ6_ZERO = Fq6(FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = Fq6(FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


class Fq12(tuple):
    """c0 + c1·w with w^2 = v (coords in Fq6)."""

    def __new__(cls, c0: Fq6, c1: Fq6):
        return super().__new__(cls, (c0, c1))

    def __add__(self, o):
        return Fq12(self[0] + o[0], self[1] + o[1])

    def __sub__(self, o):
        return Fq12(self[0] - o[0], self[1] - o[1])

    def __neg__(self):
        return Fq12(-self[0], -self[1])

    def __mul__(self, o):
        a0, a1 = self
        b0, b1 = o
        t0 = a0 * b0
        t1 = a1 * b1
        return Fq12(t0 + t1.mul_by_v(), (a0 + a1) * (b0 + b1) - t0 - t1)

    def conj(self):
        return Fq12(self[0], -self[1])

    def inv(self):
        a0, a1 = self
        t = (a0 * a0 - (a1 * a1).mul_by_v()).inv()
        return Fq12(a0 * t, -(a1 * t))

    def square(self):
        return self * self

    def pow(self, e: int):
        result = FQ12_ONE
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def is_one(self):
        return self == FQ12_ONE

    def is_zero(self):
        return self[0].is_zero() and self[1].is_zero()


FQ12_ZERO = Fq12(FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = Fq12(FQ6_ONE, FQ6_ZERO)


def fq12_from_fq(x: int) -> Fq12:
    return Fq12(Fq6(Fq2(x), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def fq12_from_fq2_w2(x: Fq2) -> Fq12:
    """x·w^2 = x·v·w^0? No: w^2 = v, so x·w^2 = (x placed at v-coeff of c0)."""
    return Fq12(Fq6(FQ2_ZERO, x, FQ2_ZERO), FQ6_ZERO)


def fq12_from_fq2_w3(x: Fq2) -> Fq12:
    """x·w^3 = x·v·w (v-coefficient of c1)."""
    return Fq12(FQ6_ZERO, Fq6(FQ2_ZERO, x, FQ2_ZERO))


# ---------------------------------------------------------------------------
# G2 (affine, coordinates in Fq2)
# ---------------------------------------------------------------------------

# Twist: y^2 = x^3 + 3/(9+u)
B2 = Fq2(3) * XI.inv()

G2_GEN_X = Fq2(
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = Fq2(
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)


class G2Point:
    __slots__ = ("x", "y", "infinity")

    def __init__(self, x: Fq2, y: Fq2, infinity: bool = False):
        self.x = x
        self.y = y
        self.infinity = infinity

    @classmethod
    def identity(cls):
        return cls(FQ2_ZERO, FQ2_ZERO, True)

    @classmethod
    def generator(cls):
        return cls(G2_GEN_X, G2_GEN_Y)

    def is_identity(self):
        return self.infinity

    def is_on_curve(self):
        if self.infinity:
            return True
        return self.y * self.y == self.x * self.x * self.x + B2

    def __eq__(self, o):
        if self.infinity or o.infinity:
            return self.infinity == o.infinity
        return self.x == o.x and self.y == o.y

    def __neg__(self):
        if self.infinity:
            return self
        return G2Point(self.x, -self.y)

    def __add__(self, o: "G2Point") -> "G2Point":
        if self.infinity:
            return o
        if o.infinity:
            return self
        if self.x == o.x:
            if self.y == -o.y:
                return G2Point.identity()
            lam = (self.x * self.x * 3) * (self.y + self.y).inv()
        else:
            lam = (o.y - self.y) * (o.x - self.x).inv()
        x3 = lam * lam - self.x - o.x
        y3 = lam * (self.x - x3) - self.y
        return G2Point(x3, y3)

    def scalar_mul(self, k: int) -> "G2Point":
        k = int(k) % BN254_FR.p
        acc = G2Point.identity()
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

    def frobenius(self) -> "G2Point":
        """π(x, y) = (conj(x)·ξ^((p-1)/3), conj(y)·ξ^((p-1)/2))."""
        return G2Point(
            self.x.conj() * _FROB_X, self.y.conj() * _FROB_Y, self.infinity
        )


_FROB_X = XI.pow((P - 1) // 3)
_FROB_Y = XI.pow((P - 1) // 2)


# ---------------------------------------------------------------------------
# Miller loop + final exponentiation
# ---------------------------------------------------------------------------

def _mul6_sparse(d: Fq6, b: Fq2, c: Fq2) -> Fq6:
    """d · (b + c·v) — 6 Fq2 muls."""
    d0, d1, d2 = d
    return Fq6(d0 * b + (d2 * c) * XI, d0 * c + d1 * b, d1 * c + d2 * b)


def _mul_by_line(f: Fq12, a: Fq2, b: Fq2, c: Fq2) -> Fq12:
    """f · (a + b·w + c·v·w): the sparse chord/tangent line
    a + B·w with A = (a,0,0), B = (b,c,0) — 18 Fq2 muls instead of a full
    Fq12 product, and no Fq12 inversions anywhere in the loop."""
    f0, f1 = f
    a0 = Fq6(f0[0] * a, f0[1] * a, f0[2] * a)
    a1 = Fq6(f1[0] * a, f1[1] * a, f1[2] * a)
    b0 = _mul6_sparse(f0, b, c)
    b1 = _mul6_sparse(f1, b, c)
    return Fq12(a0 + b1.mul_by_v(), b0 + a1)


def _mul_by_vertical(f: Fq12, a: Fq2, m: Fq2) -> Fq12:
    """f · (a + m·v) (vertical line px − tx·w²) — 12 Fq2 muls."""
    f0, f1 = f
    return Fq12(_mul6_sparse(f0, a, m), _mul6_sparse(f1, a, m))


def miller_loop(p: AffinePoint, q: G2Point) -> Fq12:
    """Optimal ate Miller loop with the tangent chain kept in Fq2 twist
    coordinates (λ ∈ Fq2 via one cheap Fq2 inversion per step; the embedded
    line py − λ·px·w + (λ·tx − ty)·v·w multiplies into f sparsely)."""
    if p.is_identity() or q.is_identity():
        return FQ12_ONE
    px, py = int(p.x), int(p.y)
    npx = Fq2(P - px if px else 0)
    py2 = Fq2(py)
    tx, ty = q.x, q.y
    f = FQ12_ONE
    three = Fq2(3)

    def add_step(f, tx, ty, qx, qy, square_first):
        if square_first:
            f = f.square()
        if tx == qx and ty == qy:
            lam = (tx * tx) * three * (ty + ty).inv()
        elif tx == qx:
            # vertical: px − tx·w²
            return _mul_by_vertical(f, Fq2(px), -tx), tx, ty
        else:
            lam = (qy - ty) * (qx - tx).inv()
        x3 = lam * lam - tx - qx
        y3 = lam * (tx - x3) - ty
        f = _mul_by_line(f, py2, lam * npx, lam * tx - ty)
        return f, x3, y3

    for bit in bin(ATE_LOOP)[3:]:  # skip the leading 1
        f, tx, ty = add_step(f, tx, ty, tx, ty, True)
        if bit == "1":
            f, tx, ty = add_step(f, tx, ty, q.x, q.y, False)
    # Frobenius correction steps
    q1 = q.frobenius()
    q2 = -(q1.frobenius())
    for qq in (q1, q2):
        f, tx, ty = add_step(f, tx, ty, qq.x, qq.y, False)
    return f


@functools.lru_cache(maxsize=1)
def _frob2_gammas():
    """γ_k = ξ^(k(p²−1)/6) for k = 0..5 — the Frobenius² coefficients.
    φ² fixes Fq2 pointwise and maps w^k → γ_k·w^k (basis w^(2j+i) for the
    Fq12 coordinate grid)."""
    e = (P * P - 1) // 6
    g1 = XI.pow(e)
    out = [Fq2(1)]
    for _ in range(5):
        out.append(out[-1] * g1)
    return out


def _frobenius2(f: Fq12) -> Fq12:
    g = _frob2_gammas()
    c0, c1 = f
    return Fq12(
        Fq6(c0[0] * g[0], c0[1] * g[2], c0[2] * g[4]),
        Fq6(c1[0] * g[1], c1[1] * g[3], c1[2] * g[5]),
    )


@functools.lru_cache(maxsize=1)
def _hard_power() -> int:
    return (P ** 4 - P ** 2 + 1) // BN254_FR.p


def final_exponentiation(f: Fq12) -> Fq12:
    """Easy part (f^(p⁶−1))^(p²+1) via conjugate·inverse + Frobenius², then
    the 1270-bit hard exponent (p⁴−p²+1)/r — ~4.4x fewer Fq12 ops than the
    monolithic (p¹²−1)/r power."""
    fe = f.conj() * f.inv()  # ^(p^6 - 1)
    fe = _frobenius2(fe) * fe  # ^(p^2 + 1)
    return fe.pow(_hard_power())


def pairing(p: AffinePoint, q: G2Point) -> Fq12:
    return final_exponentiation(miller_loop(p, q))


def pairings_product_is_identity(
    terms: Sequence[Tuple[AffinePoint, G2Point]]
) -> bool:
    """Π e(P_i, Q_i) == 1 (multi-Miller-loop then one final exp —
    util/arithmetic.rs:25-34)."""
    f = FQ12_ONE
    for (p, q) in terms:
        f = f * miller_loop(p, q)
    return final_exponentiation(f).is_one()
