# Frozen copy of plonkish_tpu_torch/utils/bh.py for the benchmark's plain reference.
"""Boolean hypercube cyclic ordering via GF(2) primitive polynomials.

HyperPlonk emulates halo2's "next row" rotation on the hypercube by walking
the multiplicative order of X in GF(2^k): next(b) = (b<<1) ^ ((b>>k)*prim),
prev(b) = (b>>1) ^ ((b&1)*x_inv).  Constant tables and semantics mirror
plonkish_backend/src/util/arithmetic/bh.rs:5-141.
"""

from __future__ import annotations

# Integer representation of primitive polynomials of GF(2^k) (bh.rs:5-38).
PRIMITIVES = [
    1, 3, 7, 11, 19, 37, 67, 131, 285, 529, 1033, 2053, 4179, 8219, 16427,
    32771, 65581, 131081, 262183, 524327, 1048585, 2097157, 4194307, 8388641,
    16777243, 33554441, 67108935, 134217767, 268435465, 536870917, 1073741907,
    2147483657,
]

# Integer representation of 1/X in GF(2^k) (bh.rs:41-74).
X_INVS = [
    0, 1, 3, 5, 9, 18, 33, 65, 142, 264, 516, 1026, 2089, 4109, 8213, 16385,
    32790, 65540, 131091, 262163, 524292, 1048578, 2097153, 4194320, 8388621,
    16777220, 33554467, 67108883, 134217732, 268435458, 536870953, 1073741828,
]


class BooleanHypercube:
    def __init__(self, num_vars: int):
        assert 0 <= num_vars < 32
        self.num_vars = num_vars
        self.primitive = PRIMITIVES[num_vars]
        self.x_inv = X_INVS[num_vars]

    def _next(self, b: int) -> int:
        b <<= 1
        b ^= (b >> self.num_vars) * self.primitive
        return b

    def _prev(self, b: int) -> int:
        return (b >> 1) ^ ((b & 1) * self.x_inv)

    def rotate(self, b: int, rotation: int) -> int:
        if rotation >= 0:
            for _ in range(rotation):
                b = self._next(b)
        else:
            for _ in range(-rotation):
                b = self._prev(b)
        return b

    def iter(self):
        """Cyclic order 0, 1, x, x^2, ... (0 is a fixed point)."""
        yield 0
        b = 1
        for _ in range((1 << self.num_vars) - 1):
            yield b
            b = self._next(b)
