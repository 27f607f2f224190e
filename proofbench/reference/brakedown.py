"""Multilinear Brakedown commitments worked out in plain Python ints, with
the hashes in numpy: the Merkle root of a polynomial's 2^k evaluations, for
the check of the Brakedown commit cells.  It imports nothing of the program.

The upstream's definition (plonkish_backend util/code/brakedown.rs and
pcs/multilinear/brakedown.rs) over BN254 Fr:

- The code (brakedown.rs:30-125): a row length picked to minimise the proof
  size, a chain of sparse matrices A_1 .. A_L shrinking the row by alpha
  until it is at most n_0 = min(20, 2^k - 1) long, a Reed-Solomon base case
  and a chain B_L .. B_1.  Each matrix is drawn from ``random.Random(code_seed)``
  as the setup draws it: the A matrices, then the B matrices; for each row
  of a matrix, distinct columns by ``randrange(m)`` until it has d of them,
  then, in increasing column order, a coefficient ``randrange(r)`` each.
- A row's codeword: the row; each A_i's output on the one before (all but
  A_L's kept); the base case, sum_i x_i (j + 1)^i for j < B_L's n, of A_L's
  output; then each B_i, from B_L up, applied to the codeword's slice that
  starts where A_i's output starts, appended.
- The commitment (brakedown.rs:152-190): the 2^k evaluations as num_rows
  rows of row_len, each row encoded; column j's message the rows' 32-byte
  little-endian canonical values at j, row after row; its Keccak-256
  (original padding) a leaf; leaves padded with zero hashes to a power of
  two; each node the hash of its two children's 64 bytes.

Arithmetic: a commitment's rows are packed into one Python int per codeword
position, row t in bytes [SLOT t, SLOT (t + 1)), so that one product of a
coefficient by a packed int multiplies every row.  A slot holds a sum of up
to 2^16 products of two values below r; each position is reduced row by row
before anything reads it.  Each commitment checked takes a process of its
own.
"""

from __future__ import annotations

import dataclasses
import math
import operator
import os
import random
import subprocess
import sys
from typing import List, Sequence, Tuple

import numpy as np

from .field import BN254_R, MONT_R
from .transcript import _RC, _ROT

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
R_INV = pow(MONT_R, -1, BN254_R)
LOG2_Q = 254  # BN254 Fr's bits
SLOT = 66  # bytes: 2 * 254 + 16 bits and more
# Figure 2 of GLSTW21 (brakedown.rs:253-260): lambda, alpha, beta, r
SPECS = {"BrakedownSpec6": (128.0, 0.2380, 0.1205, 1.720)}


# ------------------------------------------------------------------ the spec
def _ceil(v: float) -> int:
    return int(math.ceil(v))


def _h(p: float) -> float:
    q = 1.0 - p
    return -p * math.log2(p) - q * math.log2(q)


@dataclasses.dataclass(frozen=True)
class Spec:
    lambda_: float
    alpha: float
    beta: float
    r: float

    def c_n(self, n: int) -> int:
        a, b, nf = self.alpha, self.beta, float(n)
        return min(max(_ceil(1.28 * b * nf), _ceil(b * nf) + 4),
                   _ceil(((110.0 / nf) + _h(b) + a * _h(1.28 * b / a))
                         / (b * math.log2(a / (1.28 * b)))))

    def d_n(self, n: int) -> int:
        a, b, r, nf = self.alpha, self.beta, self.r, float(n)
        mu = r - 1.0 - r * a
        nu = b + a * b + 0.03
        return min(_ceil((2.0 * b + ((r - 1.0) + 110.0 / nf) / LOG2_Q) * nf),
                   _ceil((r * a * _h(b / r) + mu * _h(nu / mu) + 110.0 / nf)
                         / (a * b * math.log2(mu / nu))))

    def dimensions(self, n: int, n_0: int) -> Tuple[list, list]:
        """(n, m, d) of each A matrix and of each B matrix."""
        a_dims, cur = [], n
        while True:
            m = _ceil(cur * self.alpha)
            if cur <= n_0:
                break
            a_dims.append((cur, m, min(self.c_n(cur), m)))
            cur = m
        b_dims = []
        for an, am, _ in a_dims:
            n_prime = _ceil(am * self.r)
            m_prime = _ceil(an * self.r) - an - n_prime
            b_dims.append((n_prime, m_prime, min(self.d_n(an), m_prime)))
        return a_dims, b_dims

    def codeword_len(self, n: int, n_0: int) -> int:
        a, b = self.dimensions(n, n_0)
        return a[0][0] + sum(m for _, m, _ in a[:-1]) + b[-1][0] + sum(m for _, m, _ in b)

    def num_column_opening(self) -> int:
        return _ceil(-self.lambda_ / math.log2(1.0 - self.beta / self.r / 3.0))

    def num_proximity_testing(self, n: int, n_0: int) -> int:
        return _ceil(self.lambda_ / (LOG2_Q - math.log2(self.codeword_len(n, n_0))))


# ------------------------------------------------------------------ the code
@dataclasses.dataclass
class Code:
    num_rows: int
    row_len: int
    codeword_len: int
    a: list  # each matrix: (n, m, [(input indices, coefficients) of each output])
    b: list


def _matrix(n: int, m: int, d: int, rng: random.Random):
    outputs = [([], []) for _ in range(m)]
    for row in range(n):
        columns = set()
        while len(columns) < d:
            columns.add(rng.randrange(m))
        for col in sorted(columns):
            outputs[col][0].append(row)
            outputs[col][1].append(rng.randrange(BN254_R))
    return n, m, outputs


def shape(k: int, spec_name: str = "BrakedownSpec6"):
    """(num_rows, row_len, codeword_len, A dims, B dims) of the code at k,
    each matrix (n, m, d)."""
    spec = Spec(*SPECS[spec_name])
    n_0 = min(20, (1 << k) - 1)
    best = None
    for log2_n in range(n_0.bit_length(), k + 1):
        c, r = 1 << log2_n, 1 << (k - log2_n)
        size = (1 + spec.num_proximity_testing(c, n_0)) * c + spec.num_column_opening() * r
        if best is None or size < best[0]:
            best = (size, c)
    row_len = best[1]
    a_dims, b_dims = spec.dimensions(row_len, n_0)
    return (1 << k) // row_len, row_len, spec.codeword_len(row_len, n_0), a_dims, b_dims


def draw_code(k: int, code_seed: int, spec_name: str = "BrakedownSpec6") -> Code:
    num_rows, row_len, cw, a_dims, b_dims = shape(k, spec_name)
    rng = random.Random(code_seed)
    a = [_matrix(*dim, rng) for dim in a_dims]
    b = [_matrix(*dim, rng) for dim in b_dims]
    return Code(num_rows, row_len, cw, a, b)


# ------------------------------------------------------------- the encoding
def _pack(values: Sequence[int]) -> int:
    return int.from_bytes(b"".join(v.to_bytes(SLOT, "little") for v in values), "little")


def _reduced(packed: int, rows: int) -> int:
    raw = packed.to_bytes(SLOT * rows, "little")
    return _pack([int.from_bytes(raw[SLOT * t:SLOT * (t + 1)], "little") % BN254_R
                  for t in range(rows)])


def _apply(matrix, inputs: List[int], rows: int) -> List[int]:
    _, _, outputs = matrix
    get = inputs.__getitem__
    return [_reduced(sum(map(operator.mul, coeffs, map(get, index))), rows)
            for index, coeffs in outputs]


def encode(code: Code, inputs: List[int], rows: int) -> List[int]:
    """The codeword of `rows` packed rows, one packed int a position."""
    word = list(inputs)
    cur = word
    for a in code.a[:-1]:
        cur = _apply(a, cur, rows)
        word += cur
    tmp = _apply(code.a[-1], cur, rows)
    raw = [t.to_bytes(SLOT * rows, "little") for t in tmp]
    for j in range(code.b[-1][0]):  # the Reed-Solomon base case at the point j + 1
        powers = [pow(j + 1, i, BN254_R) for i in range(len(tmp))]
        word.append(_pack([sum(x * int.from_bytes(r[SLOT * t:SLOT * (t + 1)], "little")
                               for x, r in zip(powers, raw)) % BN254_R for t in range(rows)]))
    offset = sum(n for n, _, _ in code.a[:-1]) + code.a[-1][0] + code.a[-1][1]
    for a, b in zip(reversed(code.a), reversed(code.b)):
        offset -= a[1]
        word += _apply(b, word[offset:offset + b[0]], rows)
    assert len(word) == code.codeword_len
    return word


# ------------------------------------------------------------------- hashing
def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    return v if n == 0 else (v << np.uint64(n)) | (v >> np.uint64(64 - n))


def _keccak_f(a) -> None:
    """In place on a 5x5 list of uint64 arrays, a[x][y] (transcript.keccak_f
    over arrays: every array entry one state)."""
    for rc in _RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y] ^ d[x], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ (~b[(x + 1) % 5][y] & b[(x + 2) % 5][y])
        a[0][0] = a[0][0] ^ np.uint64(rc)


def keccak256_lanes(msgs: np.ndarray) -> np.ndarray:
    """Keccak-256 of N messages of L little-endian 64-bit lanes each,
    uint64[N, L] -> the digests' lanes uint64[N, 4]."""
    n, lanes = msgs.shape
    blocks = lanes // 17 + 1
    padded = np.zeros((n, 17 * blocks), dtype=np.uint64)
    padded[:, :lanes] = msgs
    padded[:, lanes] ^= np.uint64(0x01)
    padded[:, -1] ^= np.uint64(0x80 << 56)
    stream = np.ascontiguousarray(padded.T)
    a = [[np.zeros(n, dtype=np.uint64) for _ in range(5)] for _ in range(5)]
    for blk in range(blocks):
        for i in range(17):
            a[i % 5][i // 5] = a[i % 5][i // 5] ^ stream[17 * blk + i]
        _keccak_f(a)
    return np.stack([a[0][0], a[1][0], a[2][0], a[3][0]], axis=1)


def merkle_root(columns: np.ndarray) -> bytes:
    """columns: uint64[codeword_len, lanes], each a column's message."""
    leaves = keccak256_lanes(columns)
    width = 1 << (len(leaves) - 1).bit_length()
    level = np.zeros((width, 4), dtype=np.uint64)
    level[:len(leaves)] = leaves
    while len(level) > 1:
        level = keccak256_lanes(level.reshape(len(level) // 2, 8))
    return level[0].astype("<u8").tobytes()


# ----------------------------------------------------------- the commitment
def canonical(limbs: np.ndarray) -> List[int]:
    """Montgomery int32[n, 8] limbs (e = v 2^256 mod r) -> the values v."""
    raw = np.ascontiguousarray(limbs).view(np.uint32).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") * R_INV % BN254_R
            for i in range(0, len(raw), 32)]


def commit_root(code: Code, limbs: np.ndarray) -> bytes:
    """The root of the polynomial whose evaluations are the Montgomery
    int32[2^k, 8] `limbs`."""
    n, rows = code.row_len, code.num_rows
    values = canonical(limbs)
    word = encode(code, [_pack(values[i::n]) for i in range(n)], rows)
    raw = np.frombuffer(b"".join(w.to_bytes(SLOT * rows, "little") for w in word),
                        dtype=np.uint8).reshape(len(word), rows, SLOT)[:, :, :32]
    return merkle_root(np.ascontiguousarray(raw).reshape(len(word), -1).view("<u8"))


def commit_roots(k: int, code_seed: int, polys: Sequence[np.ndarray],
                 spec_name: str = "BrakedownSpec6") -> List[bytes]:
    """The root of each polynomial, each worked out at once in a process of
    its own (Python ints run on one core): ``python -m
    proofbench.reference.brakedown k code_seed spec`` draws the code and
    reads the limbs from its standard input."""
    procs = []
    for limbs in polys:
        proc = subprocess.Popen([sys.executable, "-m", __name__, str(k), str(code_seed), spec_name],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=REPO)
        proc.stdin.write(np.ascontiguousarray(limbs, dtype=np.int32).tobytes())
        proc.stdin.close()
        procs.append(proc)
    roots = []
    for proc in procs:
        out = proc.stdout.read()
        if proc.wait() != 0:
            raise RuntimeError(f"the reference's process exited with {proc.returncode}")
        roots.append(bytes.fromhex(out.decode()))
    return roots


if __name__ == "__main__":
    limbs = np.frombuffer(sys.stdin.buffer.read(), dtype=np.int32).reshape(-1, 8)
    code = draw_code(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.stdout.write(commit_root(code, limbs).hex())
