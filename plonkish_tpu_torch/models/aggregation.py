# Ported from plonkish_tpu/models/aggregation.py (imports resolve inside plonkish_tpu_torch);
# the witness comes from a Jacobian ladder with one batch inversion, the same values.
"""Aggregation-shaped benchmark circuit.

The reference's default bench workload is a snark-verifier KZG aggregation
circuit whose cost is dominated by in-circuit elliptic-curve arithmetic (the
accumulator MSMs): benchmark/src/halo2/circuit.rs:4-387,
run at k=20..26 (benchmark/benches/proof_system.rs:253-256).

This model reproduces that workload shape natively: every row performs one
Grumpkin point operation (double or mixed add) in affine coordinates.
Grumpkin's base field IS BN254's scalar field (the bn254/grumpkin 2-cycle,
util/arithmetic.rs:36-54), so in-circuit EC arithmetic is native field
arithmetic — the same trick production aggregation/IVC circuits use for
their accumulator ECC chips.  The rows chain through copy constraints
(row i's output point is row i+1's input point), giving a 2^k-row
double-and-add ladder = an in-circuit multi-scalar multiplication.

Layout (10 polys):
    0: pi   instance column (accumulator ladder claim, vanilla-style rows)
    1: q_dbl  selector          (preprocess)
    2: q_add  selector          (preprocess)
    3: px, 4: py  fixed base point per add-row (preprocess)
    5: x1, 6: y1  input point   (witness)
    7: x3, 8: y3  output point  (witness)
    9: lam  slope               (witness)

Gates (all degree 3 with the selector):
    add (incomplete chord):  q_add * ((px-x1)*lam - (py-y1))
                             q_add * (lam*lam - x1 - px - x3)
                             q_add * (lam*(x1-x3) - y1 - y3)
    double (tangent, a=0):   q_dbl * (2*y1*lam - 3*x1*x1)
                             q_dbl * (lam*lam - 2*x1 - x3)
                             q_dbl * (lam*(x1-x3) - y1 - y3)

Incomplete formulas are sound here because the ladder is seeded from random
multiples of the generator: an exceptional case (x1 == px, or y1 == 0) has
cryptographically negligible probability and witness generation would fail
loudly on the modular inverse.

The circuit has no lookups and no challenges, so it both proves under
HyperPlonk and folds under Protostar/Sangria (VERDICT round-1 item 5).
"""

from __future__ import annotations

import random
from typing import List, Tuple

from ..backend.circuit import MockCircuit, PlonkishCircuitInfo
from ..backend.hyperplonk.prover import row_mapping
from ..curves.specs import GRUMPKIN_G1
from ..fields.host import Fp
from ..fields.spec import FieldSpec
from ..utils import expression as ex
from ..utils.expression import Query, Rotation
from .circuits import Permutation

NUM_BASE_POINTS = 64  # fixed add-point table (aggregated-commitment stand-in)


def aggregation_circuit_info(
    spec: FieldSpec,
    num_vars: int,
    num_instances: int,
    preprocess_polys: List[List[Fp]],
    permutations: List[List[Tuple[int, int]]],
) -> PlonkishCircuitInfo:
    pi, q_dbl, q_add, px, py, x1, y1, x3, y3, lam = [
        ex.Polynomial(Query(i, Rotation(0))) for i in range(10)
    ]
    two = ex.Constant(Fp(2, spec))
    three = ex.Constant(Fp(3, spec))
    return PlonkishCircuitInfo(
        k=num_vars,
        num_instances=[num_instances],
        preprocess_polys=preprocess_polys,
        num_witness_polys=[5],
        num_challenges=[0],
        constraints=[
            q_add * ((px - x1) * lam - (py - y1)),
            q_add * (lam * lam - x1 - px - x3),
            q_add * (lam * (x1 - x3) - y1 - y3),
            q_dbl * (two * y1 * lam - three * x1 * x1),
            q_dbl * (lam * lam - two * x1 - x3),
            q_dbl * (lam * (x1 - x3) - y1 - y3),
        ],
        lookups=[],
        permutations=permutations,
        max_degree=4,
        field_spec=spec,
    )


def rand_aggregation_circuit(
    spec: FieldSpec,
    num_vars: int,
    preprocess_rng: random.Random,
    witness_rng: random.Random,
):
    """Random valid aggregation circuit + witness.

    Signature matches the other `rand_*_circuit` generators so the
    benchmark harness can drive it.  `spec` must be BN254_FR (the Grumpkin
    base field); raises otherwise.

    Witness generation runs in raw Python ints: a dozen multiplies a row in
    Jacobian coordinates and one batch inversion for all rows.
    """
    curve = GRUMPKIN_G1
    if spec.p != curve.base.p:
        raise ValueError(
            "aggregation circuit is defined over the Grumpkin base field "
            "(= BN254 scalar field)"
        )
    p = spec.p
    size = 1 << num_vars
    zero = Fp.zero(spec)
    one = Fp.one(spec)

    # Fixed base-point table: random multiples of the Grumpkin generator.
    from ..curves.host import AffinePoint

    g = AffinePoint.generator(curve)
    base_pts = [
        g.scalar_mul(preprocess_rng.randrange(1, curve.scalar.p))
        for _ in range(NUM_BASE_POINTS)
    ]
    base_xy = [(int(pt.x), int(pt.y)) for pt in base_pts]

    # Instance column: vanilla-style scattered values (the reference
    # aggregation circuit exposes accumulator limbs; here the ladder claim).
    instances = [
        Fp(witness_rng.randrange(p), spec) for _ in range(num_vars)
    ]
    pi_col = [0] * size
    for b, v in zip(row_mapping(num_vars), instances):
        pi_col[b] = int(v)

    q_dbl = [0] * size
    q_add = [0] * size
    px_col = [0] * size
    py_col = [0] * size
    x1_col = [0] * size
    y1_col = [0] * size
    x3_col = [0] * size
    y3_col = [0] * size
    lam_col = [0] * size

    # Seed accumulator: a random multiple of the generator.
    acc = g.scalar_mul(witness_rng.randrange(1, curve.scalar.p))
    ax, ay = int(acc.x), int(acc.y)

    permutation = Permutation()
    # keep all witness EC columns inside the permutation argument (row 0 is
    # the BH rotation fixed point and may not appear in cycles — like the
    # vanilla generator, anchor at row 1 and leave row 0 gate-free)
    for poly in (5, 6, 7, 8, 9):
        permutation.copy((poly, 1), (poly, 1))

    # the add/double schedule is circuit STRUCTURE (selectors + copy
    # wiring), so it must come from the preprocess rng — circuits sharing a
    # preprocess seed must be foldable into one accumulator
    schedule = format(preprocess_rng.getrandbits(size), f"0{size}b")[::-1]
    # The ladder runs in Jacobian coordinates (X, Y, Z), with no inversion a
    # row; one batch inversion of the rows' Z then gives the affine points
    # and slopes the affine formulas give: x3 = X3/Z3^2, y3 = Y3/Z3^3 and
    # lam = num/Z3, where a mixed add has num = by*Z1^3 - Y1 and
    # Z3 = Z1*(bx*Z1^2 - X1), and a doubling (a = 0) num = 3*X1^2 and
    # Z3 = 2*Y1*Z1.  A zero Z3 is the exceptional case, and pow raises on it.
    X, Y, Z = ax, ay, 1
    nums, xs, ys, zs = [], [], [], []
    for idx in range(1, size - 1):
        if schedule[idx] == "1":
            # mixed add of a fixed base point
            bx, by = base_xy[idx % NUM_BASE_POINTS]
            q_add[idx] = 1
            px_col[idx] = bx
            py_col[idx] = by
            zz = Z * Z % p
            h = (bx * zz - X) % p
            num = (by * zz % p * Z - Y) % p
            hh = h * h % p
            hhh = hh * h % p
            v = X * hh % p
            X3 = (num * num - hhh - 2 * v) % p
            Y = (num * (v - X3) - Y * hhh) % p
            Z = Z * h % p
        else:
            q_dbl[idx] = 1
            yy = Y * Y % p
            num = 3 * X * X % p
            s = 4 * X * yy % p
            X3 = (num * num - 2 * s) % p
            Z = 2 * Y * Z % p
            Y = (num * (s - X3) - 8 * yy * yy) % p
        X = X3
        nums.append(num)
        xs.append(X)
        ys.append(Y)
        zs.append(Z)
        if idx + 1 < size - 1:
            # chain: this row's output is the next row's input
            permutation.copy((7, idx), (5, idx + 1))
            permutation.copy((8, idx), (6, idx + 1))
    del schedule

    prefix, prod = [], 1
    for z in zs:
        prod = prod * z % p
        prefix.append(prod)
    inv = pow(prod, -1, p)  # 1 / (Z_1 ... Z_n)
    for i in range(len(zs) - 1, -1, -1):
        zi = inv * prefix[i - 1] % p if i else inv
        inv = inv * zs[i] % p
        zi2 = zi * zi % p
        x3_col[i + 1] = xs[i] * zi2 % p
        y3_col[i + 1] = ys[i] * zi2 % p * zi % p
        lam_col[i + 1] = nums[i] * zi % p
    del nums, xs, ys, zs, prefix
    for idx in range(1, size - 1):
        x1_col[idx], y1_col[idx] = (ax, ay) if idx == 1 else (x3_col[idx - 1], y3_col[idx - 1])

    def col(vals: List[int]) -> List[Fp]:
        return [Fp(v, spec) for v in vals]

    circuit_info = aggregation_circuit_info(
        spec,
        num_vars,
        len(instances),
        [col(q_dbl), col(q_add), col(px_col), col(py_col)],
        permutation.into_cycles(),
    )
    witness = [
        col(x1_col), col(y1_col), col(x3_col), col(y3_col), col(lam_col)
    ]
    return circuit_info, MockCircuit([instances], witness)
