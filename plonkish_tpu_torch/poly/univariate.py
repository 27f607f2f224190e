# UniPoly copied from plonkish_tpu/poly/univariate.py; DUniPoly and
# powers_tensor ported to torch.
"""Univariate polynomials in coefficient basis (port of
plonkish_tpu/poly/univariate.py).

Mirrors plonkish_backend/src/poly/univariate.rs: evaluate
(Horner), div_rem (long division), `basis` (incremental vanishing polynomial
Π(X − p_i)), and ring ops.  Two representations:

- `UniPoly`: host `Fp` coefficient lists — O(degree) sequential protocol
  algebra at small degree (verifier side, tests, eval-set bookkeeping).
- `DUniPoly`: a Montgomery ``int32[n, 8]`` tensor on the PCS's device.  The
  provers of Gemini and Zeromorph open polynomials of 2^k coefficients;
  every O(n) step (scale, add, evaluate, division by X − z) stays a few
  tensor passes.  Division by (X − z) uses the closed form
  q_i = z^{-(i+1)} · Σ_{j>i} c_j z^j (two products against power tables and
  one suffix sum) instead of the sequential Horner recurrence.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..fields import limb
from ..fields.host import Fp
from ..fields.spec import FieldSpec


def powers_tensor(spec: FieldSpec, x: Fp, n: int, device="cpu") -> torch.Tensor:
    """Montgomery [n, 8] tensor of 1, x, x^2, …, x^{n-1}, built by doubling
    (log n products of doubling width, about one full pass)."""
    c = limb._consts(spec, device)
    out = c["one"].clone()
    step = limb.d_const(spec, int(x), device)  # x^(current length)
    while out.shape[1] < n:
        out = torch.cat([out, limb.d_mul(out, step, c)], dim=1)
        step = limb.d_mul(step, step, c)
    return limb.pack(out[:, :n])


class UniPoly:
    __slots__ = ("spec", "coeffs")

    def __init__(self, spec: FieldSpec, coeffs: Sequence[Fp]):
        self.spec = spec
        self.coeffs = list(coeffs)
        self._trim()

    def _trim(self):
        while self.coeffs and self.coeffs[-1].is_zero():
            self.coeffs.pop()

    @classmethod
    def zero(cls, spec: FieldSpec) -> "UniPoly":
        return cls(spec, [])

    @classmethod
    def basis(cls, spec: FieldSpec, points: Sequence[Fp], scalar: Fp) -> "UniPoly":
        """scalar · Π (X − p) (univariate.rs:109-124), ascending coeffs."""
        coeffs = [scalar]
        zero = Fp.zero(spec)
        for point in points:
            new = [zero] * (len(coeffs) + 1)
            for i, c in enumerate(coeffs):
                new[i + 1] = new[i + 1] + c
                new[i] = new[i] - c * point
            coeffs = new
        return cls(spec, coeffs)

    def is_zero(self) -> bool:
        return not self.coeffs

    def degree(self) -> int:
        return max(0, len(self.coeffs) - 1)

    def evaluate(self, x: Fp) -> Fp:
        acc = Fp.zero(self.spec)
        for c in reversed(self.coeffs):
            acc = acc * x + c
        return acc

    def __add__(self, other: "UniPoly") -> "UniPoly":
        n = max(len(self.coeffs), len(other.coeffs))
        z = Fp.zero(self.spec)
        return UniPoly(
            self.spec,
            [
                (self.coeffs[i] if i < len(self.coeffs) else z)
                + (other.coeffs[i] if i < len(other.coeffs) else z)
                for i in range(n)
            ],
        )

    def __sub__(self, other: "UniPoly") -> "UniPoly":
        n = max(len(self.coeffs), len(other.coeffs))
        z = Fp.zero(self.spec)
        return UniPoly(
            self.spec,
            [
                (self.coeffs[i] if i < len(self.coeffs) else z)
                - (other.coeffs[i] if i < len(other.coeffs) else z)
                for i in range(n)
            ],
        )

    def scale(self, scalar: Fp) -> "UniPoly":
        return UniPoly(self.spec, [c * scalar for c in self.coeffs])

    def __mul__(self, other: "UniPoly") -> "UniPoly":
        if self.is_zero() or other.is_zero():
            return UniPoly.zero(self.spec)
        z = Fp.zero(self.spec)
        out = [z] * (len(self.coeffs) + len(other.coeffs) - 1)
        for i, a in enumerate(self.coeffs):
            if a.is_zero():
                continue
            for j, b in enumerate(other.coeffs):
                out[i + j] = out[i + j] + a * b
        return UniPoly(self.spec, out)

    def div_rem(self, divisor: "UniPoly"):
        """Long division (univariate.rs:144-168)."""
        assert not divisor.is_zero()
        if self.is_zero() or self.degree() < divisor.degree():
            return UniPoly.zero(self.spec), UniPoly(self.spec, self.coeffs)
        lead_inv = divisor.coeffs[-1].inv()
        rem = list(self.coeffs)
        qn = len(rem) - len(divisor.coeffs) + 1
        quotient = [Fp.zero(self.spec)] * qn
        for i in range(qn - 1, -1, -1):
            q = rem[i + len(divisor.coeffs) - 1] * lead_inv
            quotient[i] = q
            if not q.is_zero():
                for j, d in enumerate(divisor.coeffs):
                    rem[i + j] = rem[i + j] - q * d
        return UniPoly(self.spec, quotient), UniPoly(self.spec, rem)

    def div_by_roots(self, roots: Sequence[Fp]) -> "UniPoly":
        """Quotient by Π(X − rᵢ), remainder dropped (the batched-opening
        divisions — kzg.rs:318-330 — discard it)."""
        q, _ = self.div_rem(
            UniPoly.basis(self.spec, roots, Fp.one(self.spec))
        )
        return q


class DUniPoly:
    """Univariate polynomial as a Montgomery tensor [n, 8] on a device
    (ascending coefficients, zero tail allowed — untrimmed).

    Drop-in for the subset of the `UniPoly` API the prover-side openings
    need (scale/add/evaluate/div_by_roots/commit via tensor)."""

    __slots__ = ("spec", "coeffs")

    def __init__(self, spec: FieldSpec, coeffs: torch.Tensor):
        self.spec = spec
        self.coeffs = coeffs

    @classmethod
    def from_unipoly(cls, poly: UniPoly, device="cpu") -> "DUniPoly":
        return cls(poly.spec, limb.from_canonical_ints(
            poly.spec, [int(c) for c in poly.coeffs], device))

    def to_unipoly(self) -> UniPoly:
        return UniPoly(self.spec, [Fp(v, self.spec)
                                   for v in limb.to_canonical_ints(self.spec, self.coeffs)])

    @property
    def device(self):
        return self.coeffs.device

    def is_zero(self) -> bool:
        return self.coeffs.shape[0] == 0

    def degree(self) -> int:
        return max(0, self.coeffs.shape[0] - 1)  # upper bound (untrimmed)

    def scale(self, scalar: Fp) -> "DUniPoly":
        if self.is_zero():
            return self
        c = limb._consts(self.spec, self.device)
        d = limb.d_mul(limb.unpack(self.coeffs), limb.d_const(self.spec, int(scalar), self.device), c)
        return DUniPoly(self.spec, limb.pack(d))

    def __add__(self, other: "DUniPoly") -> "DUniPoly":
        a, b = self.coeffs, other.coeffs
        if a.shape[0] < b.shape[0]:
            a, b = b, a
        if b.shape[0] == 0:
            return DUniPoly(self.spec, a)
        head = limb.add(self.spec, a[: b.shape[0]], b)
        return DUniPoly(self.spec, torch.cat([head, a[b.shape[0]:]], dim=0))

    def evaluate(self, x: Fp) -> Fp:
        """f(x) as a host scalar: one powers table, a product and a sum."""
        spec = self.spec
        n = self.coeffs.shape[0]
        if n == 0:
            return Fp.zero(spec)
        pw = powers_tensor(spec, x, n, self.device)
        acc = limb.sum_reduce(spec, limb.mont_mul(spec, self.coeffs, pw))
        return Fp(limb.to_canonical_ints(spec, acc[None])[0], spec)

    def div_by_roots(self, roots: Sequence[Fp]) -> "DUniPoly":
        out = self
        for r in roots:
            out = out._div_by_root(r)
        return out

    def _div_by_root(self, z: Fp) -> "DUniPoly":
        """Quotient of f by (X − z): q_i = z^{-(i+1)} · Σ_{j≥i+1} c_j z^j."""
        spec = self.spec
        dev = self.device
        n = self.coeffs.shape[0]
        if n <= 1:
            return DUniPoly(spec, limb.zeros((0,), dev))
        if z.is_zero():  # degenerate (never a transcript challenge)
            return DUniPoly(spec, self.coeffs[1:])
        c = limb._consts(spec, dev)
        w = limb.d_mul(limb.unpack(self.coeffs), limb.unpack(powers_tensor(spec, z, n, dev)), c)
        s = suffix_sum(spec, w)[:, 1:]  # S_i = Σ_{j≥i+1} w_j, i = 0..n-2
        zinv = z.inv()
        inv_pw = limb.unpack(powers_tensor(spec, zinv, n - 1, dev))  # z^{-i}
        q = limb.d_mul(limb.d_mul(s, inv_pw, c), limb.d_const(spec, int(zinv), dev), c)
        return DUniPoly(spec, limb.pack(q))


def suffix_sum(spec: FieldSpec, d: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sums along the element axis of [16, n] Montgomery
    digits: lazy digit sums (below n * 2^16), then one exact reduction."""
    c = limb._consts(spec, d.device)
    lazy = d.flip(1).cumsum(1).flip(1)
    return limb.d_mul(limb.d_redc(lazy, c), c["r2"], c)
