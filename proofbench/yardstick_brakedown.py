"""The least work of the Brakedown commit's two kernels, for their roofline
shares (metrics/bd_encode_roofline_pct.py, metrics/bd_hash_roofline_pct.py),
on the frozen peaks of yardstick.py.  The code's sizes come from the plain
reference's spec (reference/brakedown.py), not from the program.

The encoding.  Every nonzero of every matrix of both chains multiplies one
element of each row, and so does every entry of the Reed-Solomon base case's
n_0' x n_B matrix (its points' powers; a Horner evaluation takes as many
products): a product is yardstick.PRODUCT_IMAD multiply-adds.  The sums are
not counted.  Bytes: the input (2^k elements), the codeword (rows x
codeword_len elements) and the matrices (each nonzero's coefficient, 32
bytes, and its input index, 4), each once.

The hashing.  One Keccak-f[1600] in 32-bit operations, each 64-bit lane two
words, with three-input logic operations (LOP3) and funnel shifts, per
round: theta's column parities 5 x 2 x 2 = 20 (two three-input XORs a
word), the rotated parities 5 x 2 = 10 (a 64-bit rotation by 1, two
shifts), their XOR into the 25 lanes 25 x 2 = 50 (a three-input XOR a word
with both parities), rho's 24 rotations 24 x 2 = 48 (lane 0's offset is 0;
pi only renames), chi 25 x 2 = 50 (one LOP3 a word: a ^ (~b & c)), iota 2:
180 a round, 4,320 over 24 rounds.  Absorbing (a block's 17 lanes XORed in)
is not counted.  Each such operation takes one lane a cycle of the
yardstick's integer rate.  Permutations: each column's message of 32 x rows
bytes in blocks of 136 (with its padding), and each node of the tree with a
real leaf under it: ceil(codeword_len / 2^l) at level l = 1 .. depth (the
nodes over padding leaves alone hash constants, which a design could
store).  Bytes: the canonical codeword once.
"""

from __future__ import annotations

import math

from .reference.brakedown import shape
from .yardstick import FE_BYTES, PRODUCT_IMAD, least_seconds

KECCAK_F_OPS = 24 * (20 + 10 + 50 + 48 + 50 + 2)  # 4,320
KECCAK_RATE_BYTES = 136
INDEX_BYTES = 4


def encode_least_work(k: int, spec_name: str = "BrakedownSpec6"):
    """(multiply-adds, bytes) one commit's encoding needs at least."""
    rows, row_len, cw, a_dims, b_dims = shape(k, spec_name)
    nonzeros = sum(n * d for n, _, d in a_dims + b_dims)
    base_case = a_dims[-1][1] * b_dims[-1][0]
    products = rows * (nonzeros + base_case)
    nbytes = (rows * row_len + rows * cw + base_case) * FE_BYTES + nonzeros * (
        FE_BYTES + INDEX_BYTES)
    return products * PRODUCT_IMAD, nbytes


def hash_least_work(k: int, spec_name: str = "BrakedownSpec6"):
    """(32-bit operations, bytes) one commit's column hashes and Merkle tree
    need at least."""
    rows, _, cw, _, _ = shape(k, spec_name)
    column_blocks = 32 * rows // KECCAK_RATE_BYTES + 1
    depth = (cw - 1).bit_length()
    nodes = sum(math.ceil(cw / (1 << level)) for level in range(1, depth + 1))
    return (cw * column_blocks + nodes) * KECCAK_F_OPS, rows * cw * FE_BYTES


def encode_least_seconds(k: int) -> float:
    return least_seconds(encode_least_work(k))


def hash_least_seconds(k: int) -> float:
    """The operations at yardstick.PEAKS["imad_per_s"], one a lane a cycle."""
    return least_seconds(hash_least_work(k))
