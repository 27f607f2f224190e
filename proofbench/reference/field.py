"""Plain prime-field arithmetic for the benchmark's reference: canonical
Python ints mod p (a frozen copy of plonkish_tpu_torch/fields/host.py, with
the field named by its modulus alone)."""

from __future__ import annotations

import dataclasses

# BN254: r is the scalar field (the proof's field), q the base field of G1.
BN254_R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
BN254_Q = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
MONT_R = 1 << 256  # the Montgomery radix of the program's int32[..., 8] limbs


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    p: int


FR = FieldSpec("bn254::Fr", BN254_R)
FQ = FieldSpec("bn254::Fq", BN254_Q)


class Fp:
    """An element of a prime field, value held as a canonical Python int."""

    __slots__ = ("v", "spec")

    def __init__(self, v: int, spec: FieldSpec):
        self.v = v % spec.p
        self.spec = spec

    @classmethod
    def zero(cls, spec):
        return cls(0, spec)

    @classmethod
    def one(cls, spec):
        return cls(1, spec)

    @classmethod
    def from_le_bytes(cls, data: bytes, spec: FieldSpec) -> "Fp":
        v = int.from_bytes(data, "little")
        if v >= spec.p:
            raise ValueError("non-canonical field repr")
        return cls(v, spec)

    @classmethod
    def mod_from_le_bytes(cls, data: bytes, spec: FieldSpec) -> "Fp":
        return cls(int.from_bytes(data, "little") % spec.p, spec)

    def to_repr(self) -> bytes:
        return self.v.to_bytes(32, "little")

    def _lift(self, other):
        if isinstance(other, Fp):
            if other.spec.p != self.spec.p:
                raise ValueError("operands of different fields")
            return other.v
        if isinstance(other, int):
            return other % self.spec.p
        return NotImplemented

    def __add__(self, o):
        v = self._lift(o)
        if v is NotImplemented:
            return NotImplemented
        return Fp(self.v + v, self.spec)

    __radd__ = __add__

    def __sub__(self, o):
        v = self._lift(o)
        if v is NotImplemented:
            return NotImplemented
        return Fp(self.v - v, self.spec)

    def __rsub__(self, o):
        v = self._lift(o)
        if v is NotImplemented:
            return NotImplemented
        return Fp(v - self.v, self.spec)

    def __mul__(self, o):
        v = self._lift(o)
        if v is NotImplemented:
            return NotImplemented
        return Fp(self.v * v, self.spec)

    __rmul__ = __mul__

    def __neg__(self):
        return Fp(-self.v, self.spec)

    def inv(self) -> "Fp":
        if self.v == 0:
            return self
        return Fp(pow(self.v, -1, self.spec.p), self.spec)

    def double(self) -> "Fp":
        return Fp(2 * self.v, self.spec)

    def __eq__(self, o):
        if isinstance(o, Fp):
            return self.v == o.v and self.spec.p == o.spec.p
        if isinstance(o, int):
            return self.v == o % self.spec.p
        return NotImplemented

    def __hash__(self):
        return hash((self.v, self.spec.p))

    def __int__(self):
        return self.v

    def __repr__(self):
        return f"Fp(0x{self.v:x})"

    def is_zero(self) -> bool:
        return self.v == 0


def batch_invert(values: list) -> list:
    """Montgomery's trick on the host; zeros pass through."""
    if not values:
        return values
    spec = values[0].spec
    prefix = []
    acc = Fp.one(spec)
    for fe in values:
        prefix.append(acc)
        if not fe.is_zero():
            acc = acc * fe
    acc = acc.inv()
    out = [None] * len(values)
    for i in range(len(values) - 1, -1, -1):
        fe = values[i]
        if fe.is_zero():
            out[i] = fe
        else:
            out[i] = acc * prefix[i]
            acc = acc * fe
    return out
