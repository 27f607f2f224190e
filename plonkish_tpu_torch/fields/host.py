# Copied from plonkish_tpu/fields/host.py; imports resolve inside plonkish_tpu_torch.
"""Host-side scalar field elements (Python ints mod p).

Protocol glue — transcripts, challenge schedules, verifier algebra — is
inherently sequential and tiny (O(k·d) elements), so it runs on host with
exact integer arithmetic, mirroring the canonical (non-Montgomery) values of
the device limb tensors.  Serialization matches halo2_curves `to_repr`:
32-byte little-endian canonical form.
"""

from __future__ import annotations

from .spec import FieldSpec


class Fp:
    """An element of a prime field, value held as a canonical Python int."""

    __slots__ = ("v", "spec")

    def __init__(self, v: int, spec: FieldSpec):
        self.v = v % spec.p
        self.spec = spec

    # -- constructors --
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
            # Explicit raise (not assert): must hold under `python -O` too,
            # or non-canonical proof encodings become malleable.
            raise ValueError("non-canonical field repr")
        return cls(v, spec)

    @classmethod
    def mod_from_le_bytes(cls, data: bytes, spec: FieldSpec) -> "Fp":
        """Reduce arbitrary LE bytes mod p (fe_mod_from_le_bytes,
        reference util/arithmetic.rs:150-152)."""
        return cls(int.from_bytes(data, "little") % spec.p, spec)

    # -- serialization (halo2 to_repr = 32-byte LE canonical) --
    def to_repr(self) -> bytes:
        return self.v.to_bytes(32, "little")

    # -- arithmetic --
    def _lift(self, other):
        if isinstance(other, Fp):
            assert other.spec.p == self.spec.p
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

    def __pow__(self, e: int):
        return Fp(pow(self.v, e, self.spec.p), self.spec)

    def inv(self) -> "Fp":
        if self.v == 0:
            return self
        return Fp(pow(self.v, -1, self.spec.p), self.spec)

    def double(self) -> "Fp":
        return Fp(2 * self.v, self.spec)

    def square(self) -> "Fp":
        return Fp(self.v * self.v, self.spec)

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
    """Host-side batch inversion (Montgomery trick); zeros pass through."""
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
