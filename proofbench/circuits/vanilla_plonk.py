"""The benchmark's frozen generator of random vanilla-PLONK circuits.

The same circuit family as the upstream's ``rand_vanilla_plonk_circuit``
(hyperplonk/util.rs:100-169) and the program's copy of it: rows 0..n-2 are
addition gates (q_l = q_r = 1, q_o = -1) or multiplication gates (q_m = 1,
q_o = -1), each with a random q_c; from row 2 on, a row copies its w_l and
w_r from random earlier cells (poly 6..8, row 1..idx-1) with probability 1/2;
the k instances sit at the hypercube rows 1, X, X^2, .. (hyperplonk.rs:365);
row n-1 is empty.  The draws come from numpy in bulk, so the streams differ
from the upstream's Python RNG, and the circuit's structure is drawn once
(``circuit``) while witnesses for it are drawn apart (``witness``): each
witness takes fresh free values and instances and propagates them through
the same copies and gates, in one pass over the rows.

All values are canonical ints mod r.  Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..reference.bh import BooleanHypercube
from ..reference.field import BN254_R

WITNESS_POLYS = (6, 7, 8)  # w_l, w_r, w_o among [pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o]


@dataclasses.dataclass
class Circuit:
    k: int
    selectors: List[List[int]]  # q_l, q_r, q_m, q_o, q_c
    cycles: List[List[Tuple[int, int]]]  # copy cycles of (poly, row), each sorted
    sigmas: List[List[int]]  # the permutation polys of w_l, w_r, w_o
    instance_rows: List[int]
    # what the witness pass walks, per row: copy flag, the sources' columns
    # (0..2 for w_l, w_r, w_o) and rows, gate kind
    copy: List[bool]
    sources: Tuple[List[int], List[int], List[int], List[int]]
    mul: List[bool]


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng([w % (1 << 64) for w in words])


def random_field(rng: np.random.Generator, n: int) -> List[int]:
    """n values below r, full width: the top 64-bit word is drawn below r's."""
    words = rng.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64)
    words[:, 3] = rng.integers(0, BN254_R >> 192, size=n, dtype=np.uint64)
    raw = words.tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def instance_rows(k: int) -> List[int]:
    it = BooleanHypercube(k).iter()
    next(it)  # row 0 holds no instance
    return [next(it) for _ in range(k)]


def circuit(k: int, seed: int) -> Circuit:
    n = 1 << k
    m = n - 1
    rng = _rng(seed, 1)
    idx = np.arange(m, dtype=np.int64)
    copy = (rng.integers(0, 2, m) == 0) & (idx > 1)
    span = np.maximum(idx - 1, 1)
    src_poly = rng.integers(6, 9, size=(2, m))
    src_row = 1 + np.minimum((rng.random((2, m)) * span).astype(np.int64), span - 1)
    mul = rng.integers(0, 2, m) == 1
    q_c = random_field(rng, m)

    minus_one = BN254_R - 1
    q_l = np.zeros(n, dtype=np.int64)
    q_l[:m][~mul] = 1
    q_m = np.zeros(n, dtype=np.int64)
    q_m[:m][mul] = 1
    q_o = [minus_one] * m + [0]
    selectors = [q_l.tolist(), q_l.tolist(), q_m.tolist(), q_o, q_c + [0]]

    # Copy cycles: each target cell (6 or 7, idx) joins the cycle of its
    # source, an earlier cell, so the cycles are the trees of "copied from"
    # links.  Cell id (poly - 6) * n + row is also its permutation id.
    parent = np.arange(3 * n, dtype=np.int64)
    rows = idx[copy]
    tl, tr = rows, n + rows
    sl = (src_poly[0][copy] - 6) * n + src_row[0][copy]
    sr = (src_poly[1][copy] - 6) * n + src_row[1][copy]
    parent[tl], parent[tr] = sl, sr
    root = parent
    while True:
        nxt = root[root]
        if np.array_equal(nxt, root):
            break
        root = nxt
    member = np.zeros(3 * n, dtype=bool)
    member[np.concatenate([tl, tr, sl, sr, np.array([1, n + 1, 2 * n + 1])])] = True
    cells = np.nonzero(member)[0]
    order = np.lexsort((cells, root[cells]))
    cells = cells[order]
    groups = root[cells]
    starts = np.flatnonzero(np.r_[True, groups[1:] != groups[:-1]])
    ends = np.r_[starts[1:], len(cells)]
    # sigma(c_t) = id(c_{t-1}), sigma(c_0) = id(c_last) (preprocessor.rs:172-203)
    prev = np.arange(len(cells)) - 1
    prev[starts] = ends - 1
    sigma = np.arange(3 * n, dtype=np.int64)
    sigma[cells] = cells[prev]
    pairs = list(zip(((cells // n) + 6).tolist(), (cells % n).tolist()))
    cycles = [pairs[a:b] for a, b in zip(starts.tolist(), ends.tolist())]

    sources = ((src_poly[0] - 6).tolist(), src_row[0].tolist(),
               (src_poly[1] - 6).tolist(), src_row[1].tolist())
    return Circuit(
        k=k, selectors=selectors, cycles=cycles,
        sigmas=[sigma[i * n:(i + 1) * n].tolist() for i in range(3)],
        instance_rows=instance_rows(k), copy=copy.tolist(), sources=sources,
        mul=mul.tolist(),
    )


def witness(c: Circuit, seed: int, index: int) -> Tuple[List[int], List[List[int]]]:
    """Instances and the columns w_l, w_r, w_o of one witness of `c`."""
    n = 1 << c.k
    rng = _rng(seed, 2, index)
    instances = random_field(rng, c.k)
    free = random_field(rng, 2 * (n - 1))
    offset = list(c.selectors[4])  # q_c + pi
    for row, value in zip(c.instance_rows, instances):
        offset[row] += value
    cols = [[0] * n for _ in WITNESS_POLYS]
    wl, wr, wo = cols
    lp, lr, rp, rr = c.sources
    copy, mul, p = c.copy, c.mul, BN254_R
    for i in range(n - 1):
        if copy[i]:
            a = cols[lp[i]][lr[i]]
            b = cols[rp[i]][rr[i]]
        else:
            a = free[2 * i]
            b = free[2 * i + 1]
        wl[i] = a
        wr[i] = b
        wo[i] = ((a * b if mul[i] else a + b) + offset[i]) % p
    return instances, cols


def satisfied(c: Circuit, instances: List[int], cols: List[List[int]]) -> bool:
    """The gate on every row and every copy hold (a check of the generator)."""
    n = 1 << c.k
    pi = [0] * n
    for row, value in zip(c.instance_rows, instances):
        pi[row] = value
    q_l, q_r, q_m, q_o, q_c = c.selectors
    wl, wr, wo = cols
    for i in range(n):
        gate = q_l[i] * wl[i] + q_r[i] * wr[i] + q_m[i] * wl[i] * wr[i] + q_o[i] * wo[i] + q_c[i] + pi[i]
        if gate % BN254_R:
            return False
    for cycle in c.cycles:
        values = {cols[poly - 6][row] for poly, row in cycle}
        if len(values) != 1:
            return False
    return True
