# Copied from plonkish_tpu/models/sha256.py; imports resolve inside plonkish_tpu_torch.
"""SHA-256 benchmark circuit (reference benchmark/src/halo2/circuit.rs:389-479).

The reference benches a halo2 `Table16` SHA-256 circuit (spread-form 16-bit
lookups).  This framework builds its own PLONKish SHA-256 from first
principles instead: a bit-decomposed circuit where every 32-bit word of the
message schedule and of the working state is witnessed as 32 boolean advice
cells, so the Σ/σ/Ch/Maj bit mixers become degree-≤3 polynomial identities
(x⊕y⊕z = x+y+z−2(xy+xz+yz)+4xyz; Ch = ef+g−eg; Maj = ab+ac+bc−2abc) and all
rotations of SHA-256 are free index permutations of the bit columns.  Gates
stay within degree 4 (selector · degree-3) and only use row rotations
{0,−1,−2,−3,−4}; word values travel between distant rows through copy
constraints (the permutation argument), exactly the role equality plays in
the reference's Table16 message schedule.

Row layout (per 512-bit block, 140 rows):
  out[8]   digest words: bits + carry, digest_j = H_j(b) + state_j  mod 2^32
  iv[4]    working-state seed rows holding (e-side, a-side) word pairs
           (H7,H3) (H6,H2) (H5,H1) (H4,H0) so that round row t reaches
           e_t/a_t at rotation −1 and h_t=e_{t−3}, d_t=a_{t−3} at −4
  rnd[64]  round t stores bits+values of e_{t+1}, a_{t+1} plus carries
  w[64]    message-schedule word W_t: bits, value, σ0/σ1 values; rows t≥16
           add the recurrence W_t = σ1(W_{t−2})+W_{t−7}+σ0(W_{t−15})+W_{t−16}

plus 8 global public rows binding the final digest to the instance column.
Multi-block messages chain through copies (block b's iv values ↔ block b−1's
digest cells), implementing full SHA-256 with standard padding.
"""

from __future__ import annotations

import hashlib
import math
import struct
from typing import Dict, List, Tuple

from ..fields.host import Fp
from ..fields.spec import BN254_FR, FieldSpec
from .circuits import Permutation  # noqa: F401  (re-export convenience)
from ..frontend.builder import CircuitBuilder, Cell

K32 = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
    0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
    0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
    0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
    0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
    0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]
H_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

M32 = 0xFFFFFFFF

PUB_ROWS = 8
OUT0, IV0, RND0, W0 = 0, 8, 12, 76
ROWS_PER_BLOCK = 140


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & M32


def _sigma0(x: int) -> int:
    return _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)


def _sigma1(x: int) -> int:
    return _rotr(x, 17) ^ _rotr(x, 19) ^ (x >> 10)


def _big0(x: int) -> int:
    return _rotr(x, 2) ^ _rotr(x, 13) ^ _rotr(x, 22)


def _big1(x: int) -> int:
    return _rotr(x, 6) ^ _rotr(x, 11) ^ _rotr(x, 25)


def _pad(message: bytes) -> bytes:
    ell = len(message)
    padded = message + b"\x80"
    padded += b"\x00" * ((56 - len(padded)) % 64)
    return padded + struct.pack(">Q", 8 * ell)


def message_for_blocks(num_blocks: int, seed: int = 0) -> bytes:
    """A message whose standard padding fills exactly `num_blocks` blocks."""
    import random

    rng = random.Random(seed)
    return bytes(rng.randrange(256) for _ in range(64 * num_blocks - 9))


def sha256_circuit(
    message: bytes, k: int | None = None, spec: FieldSpec = BN254_FR
):
    """Build (circuit_info, circuit, digest_bytes) proving
    sha256(message) == instances (8 public 32-bit digest words)."""
    blocks = _pad(message)
    m = len(blocks) // 64
    rows = PUB_ROWS + ROWS_PER_BLOCK * m
    min_k = max(3, math.ceil(math.log2(rows + 2)))
    if k is None:
        k = min_k
    assert k >= min_k, f"k={k} too small for {m} blocks (need {min_k})"

    b = CircuitBuilder(k, spec)
    inst = b.instance_column(8)
    B = [b.advice_column() for _ in range(64)]
    VAL_E, VAL_A, S0, S1 = (b.advice_column() for _ in range(4))
    I = [b.advice_column() for _ in range(4)]
    C = [b.advice_column() for _ in range(6)]
    Q_ACT, Q_IV, Q_RND, Q_W, Q_SCHED, Q_OUT, Q_PUB, F_K, F_IVE, F_IVA = (
        b.fixed_column() for _ in range(10)
    )

    q = b.query
    one = Fp(1, spec)
    two32 = Fp(1 << 32, spec)

    def xor2(x, y):
        return x + y - Fp(2, spec) * (x * y)

    def xor3(x, y, z):
        return (
            x + y + z
            - Fp(2, spec) * (x * y + x * z + y * z)
            + Fp(4, spec) * ((x * y) * z)
        )

    def word(bits):
        acc = bits[0]
        for i in range(1, 32):
            acc = acc + Fp(1 << i, spec) * bits[i]
        return acc

    def bits_at(cols, rot):
        return [q(cols[i].rot(rot)) for i in range(32)]

    EB, AB = B[:32], B[32:]

    # --- booleanity + word composition (all active rows) ---
    act = q(Q_ACT)
    for col in B + C:
        cq = q(col)
        b.gate("bool", act * (cq * cq - cq))
    b.gate("compose_e", act * (q(VAL_E) - word(bits_at(EB, 0))))
    b.gate("compose_a", act * (q(VAL_A) - word(bits_at(AB, 0))))

    # --- block-0 working-state seed ---
    b.gate("iv_e", q(Q_IV) * (q(VAL_E) - q(F_IVE)))
    b.gate("iv_a", q(Q_IV) * (q(VAL_A) - q(F_IVA)))

    # --- round gates (FIPS 180-4 §6.2.2; e_{t+1}=d+T1, a_{t+1}=T1+T2) ---
    e1, f1, g1 = bits_at(EB, -1), bits_at(EB, -2), bits_at(EB, -3)
    a1, b1_, c1_ = bits_at(AB, -1), bits_at(AB, -2), bits_at(AB, -3)
    Sig1 = word([xor3(e1[(i + 6) % 32], e1[(i + 11) % 32],
                      e1[(i + 25) % 32]) for i in range(32)])
    Ch = word([e1[i] * f1[i] + g1[i] - e1[i] * g1[i] for i in range(32)])
    Sig0 = word([xor3(a1[(i + 2) % 32], a1[(i + 13) % 32],
                      a1[(i + 22) % 32]) for i in range(32)])
    Maj = word([
        a1[i] * b1_[i] + a1[i] * c1_[i] + b1_[i] * c1_[i]
        - Fp(2, spec) * ((a1[i] * b1_[i]) * c1_[i])
        for i in range(32)
    ])
    T1 = q(VAL_E.rot(-4)) + Sig1 + Ch + q(F_K) + q(I[0])
    carry_e = q(C[0]) + Fp(2, spec) * q(C[1]) + Fp(4, spec) * q(C[2])
    carry_a = q(C[3]) + Fp(2, spec) * q(C[4]) + Fp(4, spec) * q(C[5])
    b.gate(
        "round_e",
        q(Q_RND) * (q(VAL_E) + two32 * carry_e - q(VAL_A.rot(-4)) - T1),
    )
    b.gate(
        "round_a",
        q(Q_RND) * (q(VAL_A) + two32 * carry_a - T1 - Sig0 - Maj),
    )

    # --- message schedule ---
    w0 = bits_at(EB, 0)

    def small_sigma(r1, r2, s):
        out = []
        for i in range(32):
            x, y = w0[(i + r1) % 32], w0[(i + r2) % 32]
            out.append(xor3(x, y, w0[i + s]) if i + s < 32 else xor2(x, y))
        return word(out)

    b.gate("sched_s0", q(Q_W) * (q(S0) - small_sigma(7, 18, 3)))
    b.gate("sched_s1", q(Q_W) * (q(S1) - small_sigma(17, 19, 10)))
    carry_w = q(C[0]) + Fp(2, spec) * q(C[1])
    b.gate(
        "sched_w",
        q(Q_SCHED)
        * (q(VAL_E) + two32 * carry_w
           - q(I[0]) - q(I[1]) - q(I[2]) - q(I[3])),
    )

    # --- digest: H'_j = H_j(b) + state_j mod 2^32 ---
    b.gate(
        "out",
        q(Q_OUT) * (q(VAL_E) + two32 * q(C[0]) - q(I[1]) - q(I[0])),
    )
    # --- public binding rows (global rows 0..7) ---
    b.gate("pub", q(Q_PUB) * (q(I[0]) - q(inst)))

    # ---------------- fixed assignments + copies ----------------
    fixed: Dict[Tuple[int, int], Fp] = {}

    def set_fixed(col, row, val=1):
        fixed[(col.index, row)] = Fp(val, spec)

    for j in range(PUB_ROWS):
        set_fixed(Q_PUB, j)
    for blk in range(m):
        base = PUB_ROWS + blk * ROWS_PER_BLOCK
        for j in range(8):
            set_fixed(Q_OUT, base + OUT0 + j)
            set_fixed(Q_ACT, base + OUT0 + j)
        for i in range(4):
            r = base + IV0 + i
            set_fixed(Q_ACT, r)
            if blk == 0:
                set_fixed(Q_IV, r)
                set_fixed(F_IVE, r, H_IV[7 - i])
                set_fixed(F_IVA, r, H_IV[3 - i])
        for t in range(64):
            r = base + RND0 + t
            set_fixed(Q_RND, r)
            set_fixed(Q_ACT, r)
            set_fixed(F_K, r, K32[t])
            rw = base + W0 + t
            set_fixed(Q_W, rw)
            set_fixed(Q_ACT, rw)
            if t >= 16:
                set_fixed(Q_SCHED, rw)

    def cell(col, row):
        return Cell(col, row)

    for blk in range(m):
        base = PUB_ROWS + blk * ROWS_PER_BLOCK
        for t in range(64):
            b.copy(cell(I[0], base + RND0 + t), cell(VAL_E, base + W0 + t))
            if t >= 16:
                rw = base + W0 + t
                b.copy(cell(I[0], rw), cell(S1, base + W0 + t - 2))
                b.copy(cell(I[1], rw), cell(VAL_E, base + W0 + t - 7))
                b.copy(cell(I[2], rw), cell(S0, base + W0 + t - 15))
                b.copy(cell(I[3], rw), cell(VAL_E, base + W0 + t - 16))
        for j in range(8):
            ro = base + OUT0 + j
            # state_j: a-chain words from round rows 63-j (j<4), e-chain else
            if j < 4:
                b.copy(cell(I[0], ro), cell(VAL_A, base + RND0 + 63 - j))
            else:
                b.copy(cell(I[0], ro), cell(VAL_E, base + RND0 + 63 - (j - 4)))
            # H_j(b) from this block's own iv rows
            if j < 4:
                b.copy(cell(I[1], ro), cell(VAL_A, base + IV0 + 3 - j))
            else:
                b.copy(cell(I[1], ro), cell(VAL_E, base + IV0 + 3 - (j - 4)))
        if blk > 0:
            prev = PUB_ROWS + (blk - 1) * ROWS_PER_BLOCK
            for i in range(4):
                r = base + IV0 + i
                b.copy(cell(VAL_E, r), cell(VAL_E, prev + OUT0 + 7 - i))
                b.copy(cell(VAL_A, r), cell(VAL_E, prev + OUT0 + 3 - i))
    last = PUB_ROWS + (m - 1) * ROWS_PER_BLOCK
    for j in range(PUB_ROWS):
        b.copy(cell(I[0], j), cell(VAL_E, last + OUT0 + j))

    # ---------------- witness ----------------
    wit: Dict[Tuple[int, int], Fp] = {}

    def set_bits(row, cols, value):
        for i in range(32):
            wit[(cols[i].index, row)] = Fp((value >> i) & 1, spec)

    def setv(col, row, value):
        wit[(col.index, row)] = Fp(value, spec)

    digest_words: List[int] = []
    state = list(H_IV)
    for blk in range(m):
        base = PUB_ROWS + blk * ROWS_PER_BLOCK
        block = blocks[blk * 64 : (blk + 1) * 64]
        W = list(struct.unpack(">16I", block))
        for t in range(16, 64):
            full = _sigma1(W[t - 2]) + W[t - 7] + _sigma0(W[t - 15]) + W[t - 16]
            W.append(full & M32)
            r = base + W0 + t
            carry = full >> 32
            setv(C[0], r, carry & 1)
            setv(C[1], r, carry >> 1)
            setv(I[0], r, _sigma1(W[t - 2]))
            setv(I[1], r, W[t - 7])
            setv(I[2], r, _sigma0(W[t - 15]))
            setv(I[3], r, W[t - 16])
        for t in range(64):
            r = base + W0 + t
            set_bits(r, EB, W[t])
            setv(VAL_E, r, W[t])
            setv(S0, r, _sigma0(W[t]))
            setv(S1, r, _sigma1(W[t]))
        # iv rows: (e-side H4..H7 ascending downward, a-side H0..H3)
        for i in range(4):
            r = base + IV0 + i
            ew, aw = state[7 - i], state[3 - i]
            set_bits(r, EB, ew)
            set_bits(r, AB, aw)
            setv(VAL_E, r, ew)
            setv(VAL_A, r, aw)
        a, bb, c, d, e, f, g, h = state
        for t in range(64):
            r = base + RND0 + t
            t1_full = h + _big1(e) + ((e & f) ^ (~e & g & M32)) + K32[t] + W[t]
            e_full = d + t1_full
            a_full = t1_full + _big0(a) + (
                (a & bb) ^ (a & c) ^ (bb & c)
            )
            e_new, ce = e_full & M32, e_full >> 32
            a_new, ca = a_full & M32, a_full >> 32
            set_bits(r, EB, e_new)
            set_bits(r, AB, a_new)
            setv(VAL_E, r, e_new)
            setv(VAL_A, r, a_new)
            for i in range(3):
                setv(C[i], r, (ce >> i) & 1)
                setv(C[3 + i], r, (ca >> i) & 1)
            setv(I[0], r, W[t])
            a, bb, c, d, e, f, g, h = a_new, a, bb, c, e_new, e, f, g
        out_state = [a, bb, c, d, e, f, g, h]
        new_state = []
        for j in range(8):
            ro = base + OUT0 + j
            full = state[j] + out_state[j]
            dig = full & M32
            new_state.append(dig)
            set_bits(ro, EB, dig)
            setv(VAL_E, ro, dig)
            setv(C[0], ro, full >> 32)
            setv(I[0], ro, out_state[j])
            setv(I[1], ro, state[j])
        state = new_state
    digest_words = state
    for j in range(8):
        setv(I[0], j, digest_words[j])

    instances = [[Fp(w, spec) for w in digest_words]]
    info, circuit = b.build(fixed, instances, lambda phase, ch: wit)
    digest = struct.pack(">8I", *digest_words)
    assert digest == hashlib.sha256(message).digest()
    return info, circuit, digest
