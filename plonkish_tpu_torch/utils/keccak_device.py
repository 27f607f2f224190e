"""Batched Keccak-256 on torch tensors (port of ``keccak_f`` and
``keccak256_fixed`` of plonkish_tpu/piop/fiat_shamir.py:116-185).

Brakedown's commit hashes every column of the encoded matrix and every level
of its Merkle tree on the device, one message per tensor column.  The
reference does this in XLA, not in a Pallas kernel, and so does the port: in
plain torch, over lanes of 64 bits held as two 32-bit halves in int64
tensors (so that every shift is exact and no sign bit is ever set), with the
whole batch of messages absorbed together, one Keccak-f[1600] per 136-byte
block.  The state is ``[25, N]``, flat lane index x + 5y.
"""

from __future__ import annotations

import torch

RATE_BYTES = 136
RATE_LANES = RATE_BYTES // 8
M32 = 0xFFFFFFFF

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offsets r[x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _tables(device):
    """Index and shift tensors of one round, on `device`."""
    perm, rots = [0] * 25, [0] * 25
    for x in range(5):
        for y in range(5):
            j = y + 5 * ((2 * x + 3 * y) % 5)  # rho + pi: B[y, 2x + 3y] = rot(A[x, y])
            perm[j] = x + 5 * y
            rots[j] = _ROT[x][y]
    chi1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
    chi2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]

    def t(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    swap = t([(r // 32) % 2 for r in rots]).bool().unsqueeze(1)
    shift = t([r % 32 for r in rots]).unsqueeze(1)
    return {
        "perm": t(perm), "swap": swap, "shift": shift, "chi1": t(chi1), "chi2": t(chi2),
        "left": t([(x - 1) % 5 for x in range(5)]), "right": t([(x + 1) % 5 for x in range(5)]),
        "theta": t([i % 5 for i in range(25)]),
        "rc_lo": [rc & M32 for rc in _RC], "rc_hi": [rc >> 32 for rc in _RC],
    }


def _rotl(lo, hi, shift):
    """Rotate 64-bit lanes (halves lo, hi < 2^32) left by `shift` < 32."""
    return (((lo << shift) | (hi >> (32 - shift))) & M32,
            ((hi << shift) | (lo >> (32 - shift))) & M32)


def keccak_f(lo: torch.Tensor, hi: torch.Tensor):
    """Keccak-f[1600] on [25, N] lane halves; every column is one state."""
    tb = _tables(lo.device)
    for rnd in range(24):
        # theta
        c_lo = lo.reshape(5, 5, -1)
        c_hi = hi.reshape(5, 5, -1)
        c_lo = c_lo[0] ^ c_lo[1] ^ c_lo[2] ^ c_lo[3] ^ c_lo[4]
        c_hi = c_hi[0] ^ c_hi[1] ^ c_hi[2] ^ c_hi[3] ^ c_hi[4]
        r_lo, r_hi = _rotl(c_lo[tb["right"]], c_hi[tb["right"]], 1)
        d_lo = c_lo[tb["left"]] ^ r_lo
        d_hi = c_hi[tb["left"]] ^ r_hi
        lo = lo ^ d_lo[tb["theta"]]
        hi = hi ^ d_hi[tb["theta"]]
        # rho and pi
        p_lo, p_hi = lo[tb["perm"]], hi[tb["perm"]]
        s_lo = torch.where(tb["swap"], p_hi, p_lo)
        s_hi = torch.where(tb["swap"], p_lo, p_hi)
        b_lo, b_hi = _rotl(s_lo, s_hi, tb["shift"])
        # chi
        lo = b_lo ^ ((b_lo[tb["chi1"]] ^ M32) & b_lo[tb["chi2"]])
        hi = b_hi ^ ((b_hi[tb["chi1"]] ^ M32) & b_hi[tb["chi2"]])
        # iota
        lo[0] ^= tb["rc_lo"][rnd]
        hi[0] ^= tb["rc_hi"][rnd]
    return lo, hi


def keccak256_fixed(msg_words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """Keccak-256 of N messages of n_bytes each: msg_words int64[ceil(n_bytes
    / 4), N] (little-endian 32-bit words, the tail of a partial word zero)
    -> int64[8, N] digest words."""
    words = -(-n_bytes // 4)
    if msg_words.shape[0] != words:
        raise ValueError(f"{n_bytes} bytes take {words} words, got {msg_words.shape[0]}")
    n = msg_words.shape[1]
    dev = msg_words.device
    blocks = n_bytes // RATE_BYTES + 1
    total = 2 * RATE_LANES * blocks
    stream = torch.zeros((total, n), dtype=torch.int64, device=dev)
    stream[:words] = msg_words & M32
    stream[n_bytes // 4] |= 0x01 << (8 * (n_bytes % 4))  # pad10*1: the domain bit
    stream[total - 1] |= 0x80000000
    lo = torch.zeros((25, n), dtype=torch.int64, device=dev)
    hi = torch.zeros((25, n), dtype=torch.int64, device=dev)
    for b in range(blocks):
        blk = stream[2 * RATE_LANES * b: 2 * RATE_LANES * (b + 1)]
        lo[:RATE_LANES] ^= blk[0::2]
        hi[:RATE_LANES] ^= blk[1::2]
        lo, hi = keccak_f(lo, hi)
    return torch.stack([lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], lo[3], hi[3]])


def words_from_bytes(blobs, device="cpu") -> torch.Tensor:
    """Messages of one length as int64[ceil(len / 4), N] little-endian words."""
    import numpy as np

    length = len(blobs[0])
    pad = -length % 4
    arr = np.frombuffer(b"".join(bytes(b) + b"\x00" * pad for b in blobs), dtype="<u4")
    arr = arr.reshape(len(blobs), (length + pad) // 4).T.astype(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


def digests_to_bytes(words: torch.Tensor):
    """int64[8, N] digest words -> N 32-byte digests."""
    import numpy as np

    arr = words.T.contiguous().cpu().numpy().astype("<u4")
    return [row.tobytes() for row in arr]
