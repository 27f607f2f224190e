"""Keccak-256 and the proof transcript's reading side, for the benchmark's
reference: frozen copies of the pure-Python hasher of
plonkish_tpu_torch/utils/keccak.py (original Keccak padding 0x01, as the
upstream's ``sha3::Keccak256``) and of ``Keccak256Transcript``'s reads
(plonkish_tpu_torch/utils/transcript.py)."""

from __future__ import annotations

import io

from .curve import G1
from .field import Fp, FieldSpec

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK64 = (1 << 64) - 1


def _rotl(x, n):
    n %= 64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def keccak_f(state: list) -> None:
    """In-place Keccak-f[1600] on a 5x5 list of 64-bit lane ints (state[x][y])."""
    a = state
    for rc in _RC:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= rc


class _PyKeccak256:
    """Incremental Keccak-256 hasher (rate 136, capacity 64, pad 0x01)."""

    RATE = 136
    DIGEST_SIZE = 32

    def __init__(self):
        self._state = [[0] * 5 for _ in range(5)]
        self._buf = b""

    def update(self, data: bytes):
        self._buf += bytes(data)
        while len(self._buf) >= self.RATE:
            self._absorb(self._buf[: self.RATE])
            self._buf = self._buf[self.RATE:]
        return self

    def _absorb(self, block: bytes) -> None:
        for i in range(self.RATE // 8):
            lane = int.from_bytes(block[8 * i: 8 * i + 8], "little")
            x, y = i % 5, i // 5
            self._state[x][y] ^= lane
        keccak_f(self._state)

    def digest(self) -> bytes:
        # pad10*1 with Keccak domain bit 0x01
        pad_len = self.RATE - len(self._buf)
        if pad_len == 1:
            block = self._buf + b"\x81"
        else:
            block = self._buf + b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
        state = [row[:] for row in self._state]
        for off in range(0, len(block), self.RATE):
            chunk = block[off: off + self.RATE]
            for i in range(self.RATE // 8):
                lane = int.from_bytes(chunk[8 * i: 8 * i + 8], "little")
                x, y = i % 5, i // 5
                state[x][y] ^= lane
            keccak_f(state)
        out = b""
        for i in range(self.DIGEST_SIZE // 8):
            x, y = i % 5, i // 5
            out += state[x][y].to_bytes(8, "little")
        return out

    def finalize_reset(self) -> bytes:
        out = self.digest()
        self._state = [[0] * 5 for _ in range(5)]
        self._buf = b""
        return out


class TranscriptReader:
    """Reads a proof as the verifier does: every element read is absorbed,
    and each challenge is the digest so far, fed back."""

    def __init__(self, spec: FieldSpec, proof: bytes):
        self.spec = spec
        self.state = _PyKeccak256()
        self.stream = io.BytesIO(proof)

    def squeeze_challenge(self) -> Fp:
        h = self.state.finalize_reset()
        self.state.update(h)
        return Fp.mod_from_le_bytes(h, self.spec)

    def squeeze_challenges(self, n: int) -> list:
        return [self.squeeze_challenge() for _ in range(n)]

    def common_field_element(self, fe: Fp) -> None:
        self.state.update(fe.to_repr())

    def read_field_element(self) -> Fp:
        data = self.stream.read(32)
        if len(data) != 32:
            raise EOFError("transcript stream exhausted")
        fe = Fp.from_le_bytes(data[::-1], self.spec)
        self.common_field_element(fe)
        return fe

    def read_field_elements(self, n: int) -> list:
        return [self.read_field_element() for _ in range(n)]

    def read_point(self):
        """An affine G1 point, (0, 0) for the identity, big-endian x then y."""
        xb, yb = self.stream.read(32), self.stream.read(32)
        if len(xb) != 32 or len(yb) != 32:
            raise EOFError("transcript stream exhausted")
        x = Fp.from_le_bytes(xb[::-1], G1.base).v
        y = Fp.from_le_bytes(yb[::-1], G1.base).v
        point = None if x == 0 and y == 0 else G1.checked(x, y)
        if point is None:
            self.state.update(b"\x00" * 64)
        else:
            self.state.update(x.to_bytes(32, "little"))
            self.state.update(y.to_bytes(32, "little"))
        return point

    def at_end(self) -> bool:
        return self.stream.read(1) == b""
