# Copied from plonkish_tpu/curves/specs.py; imports resolve inside plonkish_tpu_torch.
"""Short-Weierstrass curve specifications (y^2 = x^3 + b, a = 0).

The reference takes these from halo2_curves (BN254/Grumpkin/Pasta 2-cycles,
util/arithmetic.rs:36-54).  All four supported curves have a = 0 and prime
order, which makes the Renes–Costello *complete* addition formulas available:
branch-free point addition that is correct for doubling and identity inputs —
exactly what SIMD bucket accumulation on TPU needs.
"""

from __future__ import annotations

import dataclasses
import functools

from ..fields.spec import (
    BN254_FQ,
    BN254_FR,
    PALLAS_BASE,
    VESTA_BASE,
    FieldSpec,
)


def sqrt_mod(a: int, p: int) -> int:
    """Tonelli–Shanks square root mod p (None-equivalent raises)."""
    a %= p
    if a == 0:
        return 0
    assert pow(a, (p - 1) // 2, p) == 1, "not a quadratic residue"
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general Tonelli–Shanks
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    name: str
    base: FieldSpec  # coordinate field
    scalar: FieldSpec  # scalar field (group order)
    b: int  # curve constant
    gen_x: int
    gen_y: int

    @functools.cached_property
    def b3(self) -> int:
        return (3 * self.b) % self.base.p


BN254_G1 = CurveSpec(
    "bn254::G1", BN254_FQ, BN254_FR, b=3, gen_x=1, gen_y=2
)

# Grumpkin: y^2 = x^3 - 17 over BN254's scalar field; generator (1, sqrt(-16)).
_GRUMPKIN_P = BN254_FR.p
GRUMPKIN_G1 = CurveSpec(
    "grumpkin::G1",
    BN254_FR,
    BN254_FQ,
    b=_GRUMPKIN_P - 17,
    gen_x=1,
    gen_y=sqrt_mod(-16, _GRUMPKIN_P),
)

# Pasta 2-cycle: y^2 = x^3 + 5, generators (-1, 2).
PALLAS = CurveSpec(
    "pasta::pallas", PALLAS_BASE, VESTA_BASE, b=5,
    gen_x=PALLAS_BASE.p - 1, gen_y=2,
)
VESTA = CurveSpec(
    "pasta::vesta", VESTA_BASE, PALLAS_BASE, b=5,
    gen_x=VESTA_BASE.p - 1, gen_y=2,
)
