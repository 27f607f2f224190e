# Copied from plonkish_tpu/utils/transcript.py; imports resolve inside plonkish_tpu_torch.
"""Fiat–Shamir transcript, byte-compatible with the reference's
`Keccak256Transcript` (plonkish_backend/src/util/transcript.rs).

Semantics replicated exactly:
- `state` is an incremental Keccak256 absorbing protocol messages.
- squeeze_challenge: h = state.finalize_reset(); state.update(h);
  challenge = int_le(h) mod p                       (transcript.rs:127-131)
- common_field_element absorbs the 32-byte **little-endian** canonical repr
  (hash.rs:19-21); the proof stream stores field elements **big-endian**
  (repr reversed — transcript.rs:158-165).
- curve-point commitments absorb x then y (LE reprs) and stream both
  big-endian (transcript.rs:171-228).
- Keccak256-output commitments (Brakedown merkle roots/paths) are absorbed
  raw on `common`, and written/read on the stream WITHOUT absorbing
  (transcript.rs:240-264).

The transcript is the protocol-forced host-side serialization point; all
inputs are host `Fp` scalars.
"""

from __future__ import annotations

import io

from ..fields.host import Fp
from ..fields.spec import FieldSpec
from .keccak import Keccak256


class Keccak256Transcript:
    def __init__(self, spec: FieldSpec, proof: bytes | None = None):
        self.spec = spec
        self.state = Keccak256()
        if proof is None:
            self.stream = io.BytesIO()
            self._reading = False
        else:
            self.stream = io.BytesIO(proof)
            self._reading = True

    # ---- lifecycle ----
    @classmethod
    def from_proof(cls, spec: FieldSpec, proof: bytes) -> "Keccak256Transcript":
        return cls(spec, proof=proof)

    def into_proof(self) -> bytes:
        return self.stream.getvalue()

    def export_sponge(self):
        """Current Keccak state as (25 lane ints, pending bytes) — seeds
        the device-resident sum-check sponge (piop/fiat_shamir.py)."""
        return self.state.export_state()

    # ---- squeezing ----
    def squeeze_challenge(self) -> Fp:
        h = self.state.finalize_reset()
        self.state.update(h)
        return Fp.mod_from_le_bytes(h, self.spec)

    def squeeze_challenges(self, n: int) -> list:
        return [self.squeeze_challenge() for _ in range(n)]

    # ---- field elements ----
    def common_field_element(self, fe: Fp) -> None:
        self.state.update(fe.to_repr())

    def common_field_elements(self, fes) -> None:
        for fe in fes:
            self.common_field_element(fe)

    def write_field_element(self, fe: Fp) -> None:
        self.common_field_element(fe)
        self.stream.write(fe.to_repr()[::-1])  # big-endian on the wire

    def write_field_elements(self, fes) -> None:
        for fe in fes:
            self.write_field_element(fe)

    def read_field_element(self, spec: FieldSpec | None = None) -> Fp:
        spec = spec or self.spec
        data = self.stream.read(32)
        if len(data) != 32:
            raise EOFError("transcript stream exhausted")
        fe = Fp.from_le_bytes(data[::-1], spec)
        self.common_field_element(fe)
        return fe

    def read_field_elements(self, n: int) -> list:
        return [self.read_field_element() for _ in range(n)]

    # ---- curve-point commitments (affine x/y in the base field) ----
    # The identity is encoded as (0, 0) — unambiguous on y^2 = x^3 + b with
    # b != 0 (all supported curves).
    def common_point(self, point) -> None:
        if point.is_identity():
            zero = b"\x00" * 32
            self.state.update(zero)
            self.state.update(zero)
            return
        self.state.update(point.x.to_repr())
        self.state.update(point.y.to_repr())

    def write_point(self, point) -> None:
        self.common_point(point)
        if point.is_identity():
            self.stream.write(b"\x00" * 64)
            return
        self.stream.write(point.x.to_repr()[::-1])
        self.stream.write(point.y.to_repr()[::-1])

    def read_point(self, curve):
        xb = self.stream.read(32)
        yb = self.stream.read(32)
        if len(xb) != 32 or len(yb) != 32:
            raise EOFError("transcript stream exhausted")
        from ..curves.host import AffinePoint

        x = Fp.from_le_bytes(xb[::-1], curve.base)
        y = Fp.from_le_bytes(yb[::-1], curve.base)
        if x.is_zero() and y.is_zero():
            point = AffinePoint.identity(curve)
        else:
            point = AffinePoint.from_xy(curve, x, y)
        self.common_point(point)
        return point

    # ---- raw 32-byte commitments (hash outputs, e.g. Brakedown roots) ----
    def common_commitment_hash(self, digest: bytes) -> None:
        assert len(digest) == 32
        self.state.update(digest)

    def write_commitment_hash(self, digest: bytes) -> None:
        # NB: the reference does NOT absorb hash commitments on write/read
        # (transcript.rs:257-263); callers absorb via common_commitment
        # where the protocol requires it.
        assert len(digest) == 32
        self.stream.write(digest)

    def read_commitment_hash(self) -> bytes:
        data = self.stream.read(32)
        if len(data) != 32:
            raise EOFError("transcript stream exhausted")
        return data
