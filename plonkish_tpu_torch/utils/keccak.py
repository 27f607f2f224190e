# Copied from plonkish_tpu/utils/keccak.py; the native hasher is always the choice.
"""Keccak-256 (original Keccak padding 0x01, as used by Ethereum / sha3 crate's
`Keccak256`, NOT NIST SHA3-256).

The transcript layer needs bit-exact Keccak-256 (reference uses the Rust
`sha3::Keccak256` digest — plonkish_backend/src/util/hash.rs:5-8).
Transcript traffic is tiny (32-byte absorbs per protocol message), so a pure
Python implementation of Keccak-f[1600] suffices.
"""

from __future__ import annotations

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

    def export_state(self):
        """(25 lane ints in absorb order i -> state[i%5][i//5], pending
        bytes) — for seeding a device-resident sponge."""
        lanes = [self._state[i % 5][i // 5] for i in range(25)]
        return lanes, self._buf


class _NativeKeccak256:
    """Buffering hasher that defers to the native one-shot kernel (streaming
    Keccak of a message equals one-shot Keccak of its concatenation)."""

    __slots__ = ("_parts",)

    def __init__(self):
        self._parts = []

    def update(self, data: bytes):
        self._parts.append(bytes(data))
        return self

    def digest(self) -> bytes:
        from ..ops.keccak_batch import keccak256_many

        return keccak256_many([b"".join(self._parts)])[0]

    def finalize_reset(self) -> bytes:
        out = self.digest()
        self._parts = []
        return out

    def export_state(self):
        """See _PyKeccak256.export_state (replays absorbs in Python —
        transcript traffic is tiny)."""
        h = _PyKeccak256()
        h.update(b"".join(self._parts))
        return h.export_state()


# The transcript's hasher: the native one, built with g++ at its first use
# (ops/_keccak_native.py); a failed build raises there.
Keccak256 = _NativeKeccak256


def keccak256(data: bytes) -> bytes:
    return _PyKeccak256().update(data).digest()
