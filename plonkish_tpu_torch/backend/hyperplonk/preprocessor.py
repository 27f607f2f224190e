# Copied from plonkish_tpu/backend/hyperplonk/preprocessor.py; permutation_polys takes a device.
"""HyperPlonk preprocessor: composes the single zero-check expression from
gates + logUp lookup constraints + chunked grand-product permutation
constraints, and builds the permutation (sigma) polynomials.

Semantics mirror plonkish_backend/src/backend/hyperplonk/
preprocessor.rs exactly (the composed AST is golden-tested node-for-node);
everything here is symbolic host-side work done once per circuit.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

from ...fields.host import Fp
from ...fields.spec import FieldSpec
from ...poly.multilinear import MLPoly
from ...utils import expression as ex
from ...utils.expression import Expression, Query, Rotation
from ..circuit import PlonkishCircuitInfo


def div_ceil(a: int, b: int) -> int:
    return -(-a // b)


def batch_size(circuit_info: PlonkishCircuitInfo) -> int:
    """PCS batch-size estimate (preprocessor.rs:13-23)."""
    num_lookups = len(circuit_info.lookups)
    num_permutation_polys = len(circuit_info.permutation_polys())
    return (
        len(circuit_info.preprocess_polys)
        + num_permutation_polys
        + sum(circuit_info.num_witness_polys)
        + num_lookups
        + num_lookups
        + div_ceil(num_permutation_polys, max_degree(circuit_info, None) - 1)
    )


def max_degree(
    circuit_info: PlonkishCircuitInfo,
    lookup_constraints_: Optional[List[Expression]] = None,
) -> int:
    """preprocessor.rs:62-77."""
    if lookup_constraints_ is None:
        spec = _spec_of(circuit_info)
        dummy = ex.Constant(Fp.zero(spec))
        lookup_constraints_ = lookup_constraints(circuit_info, dummy, dummy)[0]
    candidates = (
        [c.degree() for c in circuit_info.constraints]
        + [c.degree() for c in lookup_constraints_]
        + ([circuit_info.max_degree] if circuit_info.max_degree is not None else [])
        + [2]
    )
    return max(candidates)


def _spec_of(circuit_info: PlonkishCircuitInfo) -> FieldSpec:
    # find a field spec from any constant in the circuit; default BN254 Fr
    from ...fields.spec import BN254_FR

    return getattr(circuit_info, "field_spec", None) or BN254_FR


def lookup_constraints(
    circuit_info: PlonkishCircuitInfo,
    beta: Expression,
    gamma: Expression,
) -> Tuple[List[Expression], List[Expression]]:
    """logUp constraints (preprocessor.rs:79-109):
    h·(input+γ)·(table+γ) − (table+γ) + m·(input+γ),  plus Σ h = 0 checks."""
    m_offset = circuit_info.num_poly() + len(circuit_info.permutation_polys())
    h_offset = m_offset + len(circuit_info.lookups)
    constraints = []
    for lookup_idx, lookup in enumerate(circuit_info.lookups):
        m = ex.Polynomial(Query(m_offset + lookup_idx, Rotation(0)))
        h = ex.Polynomial(Query(h_offset + lookup_idx, Rotation(0)))
        inputs = [inp for (inp, _) in lookup]
        tables = [tbl for (_, tbl) in lookup]
        inp = ex.distribute_powers(inputs, beta)
        tbl = ex.distribute_powers(tables, beta)
        constraints.append(
            h * (inp + gamma) * (tbl + gamma) - (tbl + gamma) + m * (inp + gamma)
        )
    sum_checks = [
        ex.Polynomial(Query(h_offset + i, Rotation(0)))
        for i in range(len(circuit_info.lookups))
    ]
    return constraints, sum_checks


def permutation_constraints(
    circuit_info: PlonkishCircuitInfo,
    max_degree_: int,
    beta: Expression,
    gamma: Expression,
    num_builtin_witness_polys: int,
) -> Tuple[int, List[Expression]]:
    """Chunked grand-product constraints (preprocessor.rs:111-170)."""
    spec = _spec_of(circuit_info)
    permutation_polys = circuit_info.permutation_polys()
    chunk_size = max_degree_ - 1
    num_chunks = div_ceil(len(permutation_polys), chunk_size)
    permutation_offset = circuit_info.num_poly()
    z_offset = (
        permutation_offset + len(permutation_polys) + num_builtin_witness_polys
    )
    polys = [
        ex.Polynomial(Query(idx, Rotation(0))) for idx in permutation_polys
    ]
    ids = [
        ex.Constant(Fp(idx << circuit_info.k, spec)) + ex.identity()
        for idx in range(len(polys))
    ]
    permutations = [
        ex.Polynomial(Query(permutation_offset + i, Rotation(0)))
        for i in range(len(permutation_polys))
    ]
    zs = [
        ex.Polynomial(Query(z_offset + i, Rotation(0))) for i in range(num_chunks)
    ]
    z_0_next = ex.Polynomial(Query(z_offset, Rotation(1)))
    l_1 = ex.lagrange(1)
    one = ex.Constant(Fp.one(spec))

    constraints = []
    if zs:
        constraints.append(l_1 * (zs[0] - one))
    z_rhs_seq = zs[1:] + [z_0_next]
    for c in range(num_chunks):
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, len(polys))
        lhs_prod = None
        rhs_prod = None
        for i in range(lo, hi):
            lhs_term = polys[i] + beta * ids[i] + gamma
            rhs_term = polys[i] + beta * permutations[i] + gamma
            lhs_prod = lhs_term if lhs_prod is None else lhs_prod * lhs_term
            rhs_prod = rhs_term if rhs_prod is None else rhs_prod * rhs_term
        constraints.append(zs[c] * lhs_prod - z_rhs_seq[c] * rhs_prod)
    return num_chunks, constraints


def compose(circuit_info: PlonkishCircuitInfo) -> Tuple[int, Expression]:
    """Build the single zero-check expression (preprocessor.rs:25-60)."""
    challenge_offset = sum(circuit_info.num_challenges)
    beta = ex.Challenge(challenge_offset)
    gamma = ex.Challenge(challenge_offset + 1)
    alpha = ex.Challenge(challenge_offset + 2)

    lookup_cons, lookup_zero_checks = lookup_constraints(
        circuit_info, beta, gamma
    )
    md = max_degree(circuit_info, lookup_cons)
    num_permutation_z_polys, permutation_cons = permutation_constraints(
        circuit_info, md, beta, gamma, 2 * len(circuit_info.lookups)
    )

    constraints = (
        list(circuit_info.constraints) + lookup_cons + permutation_cons
    )
    eq = ex.eq_xy(0)
    zero_check_on_every_row = ex.distribute_powers(constraints, alpha) * eq
    expression = ex.distribute_powers(
        lookup_zero_checks + [zero_check_on_every_row], alpha
    )
    return num_permutation_z_polys, expression


def permutation_polys(
    spec: FieldSpec,
    num_vars: int,
    permutation_poly_indices: List[int],
    cycles: List[List[Tuple[int, int]]],
    device,
) -> List[MLPoly]:
    """Sigma polynomials: identity values idx·2^k + row, cycle-rotated
    (preprocessor.rs:172-203)."""
    poly_index = {}
    for idx, poly in enumerate(permutation_poly_indices):
        poly_index[poly] = idx
    n = 1 << num_vars
    perms = [
        [(idx << num_vars) + row for row in range(n)]
        for idx in range(len(permutation_poly_indices))
    ]
    for cycle in cycles:
        (i0, j0) = cycle[0]
        last = perms[poly_index[i0]][j0]
        # walk cycle.iter().cycle().skip(1).take(len) — i.e. elements
        # 1..len then the first again, swapping `last` through
        walk = cycle[1:] + [cycle[0]]
        for (i, j) in walk:
            assert j != 0
            perms[poly_index[i]][j], last = last, perms[poly_index[i]][j]
    return [MLPoly.from_ints(spec, p, device) for p in perms]
