"""Multilinear KZG commitments worked out from the trapdoor.

The SRS is part of a configuration: its trapdoor s = (s_0, .., s_{k-1}) is
drawn as the upstream's setup draws it (kzg.rs:174-195, and
plonkish_tpu_torch/pcs/kzg.py), s_i = Random(srs_seed).randrange(1, r) in
turn, and the prover's table for 2^k evaluations holds eq(s, b) G for every
b, index bit i <-> s_i.  So the commitment of f is f~(s) G, where
f~(s) = sum_b f(b) eq(s, b): one inner product and one scalar product on the
host, independent of any MSM.
"""

from __future__ import annotations

import operator
import random
from typing import List, Sequence

import numpy as np

from .curve import G1
from .field import BN254_R, MONT_R

R_INV = pow(MONT_R, -1, BN254_R)


def trapdoor(k: int, srs_seed: int) -> List[int]:
    rng = random.Random(srs_seed)
    return [rng.randrange(1, BN254_R) for _ in range(k)]


def eq_table(s: Sequence[int]) -> List[int]:
    """eq(s, b) mod r for every b in {0,1}^len(s), index bit i <-> s_i."""
    level = [1]
    for s_i in s:
        hi = [v * s_i % BN254_R for v in level]
        lo = [(v - h) % BN254_R for v, h in zip(level, hi)]
        level = lo + hi
    return level


def eq_at(s: Sequence[int], b: int) -> int:
    """eq(s, b) mod r for one index b, bit i <-> s_i."""
    out = 1
    for i, s_i in enumerate(s):
        out = out * (s_i if (b >> i) & 1 else 1 - s_i) % BN254_R
    return out


def commit_one_hot(s: Sequence[int], b: int):
    """The commitment of the polynomial that is 1 at b and 0 elsewhere."""
    return G1.mul(G1.gen, eq_at(s, b))


def ints_from_limbs(limbs: np.ndarray) -> List[int]:
    """int32/uint32[n, 8] little-endian 32-bit limbs -> n Python ints."""
    raw = np.ascontiguousarray(limbs).view(np.uint32).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def evaluate_at_trapdoor(values: Sequence[int], eq: Sequence[int]) -> int:
    if len(values) != len(eq):
        raise ValueError("a polynomial and its eq table differ in size")
    return sum(map(operator.mul, values, eq)) % BN254_R


def commit(values: Sequence[int], eq: Sequence[int]):
    """[f~(s)] G for canonical evaluations f."""
    return G1.mul(G1.gen, evaluate_at_trapdoor(values, eq))


def commit_montgomery(limbs: np.ndarray, eq: Sequence[int]):
    """The commitment of the polynomial whose evaluations are stored as
    Montgomery limbs e = f 2^256 mod r: f~(s) = 2^-256 sum_b e_b eq(s, b)."""
    return G1.mul(G1.gen, evaluate_at_trapdoor(ints_from_limbs(limbs), eq) * R_INV % BN254_R)
