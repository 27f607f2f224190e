# Copied from plonkish_tpu/models/circuits.py; imports resolve inside plonkish_tpu_torch.
"""Circuit families ("models") for tests and benchmarks.

Ports the semantics of plonkish_backend/src/backend/
hyperplonk/util.rs: vanilla-PLONK circuit-info builders, valid random
circuit/witness generators, and the `Permutation` cycle builder.  Seeded
Python RNG replaces Rust's seeded StdRng (self-consistent witness + copy
constraints, not bit-matched to the Rust streams).
"""

from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

from ..backend.circuit import MockCircuit, PlonkishCircuitInfo
from ..backend.hyperplonk.preprocessor import compose
from ..backend.hyperplonk.prover import row_mapping
from ..fields.host import Fp
from ..fields.spec import BN254_FR, FieldSpec
from ..utils import expression as ex
from ..utils.expression import Query, Rotation


def vanilla_plonk_circuit_info(
    spec: FieldSpec,
    num_vars: int,
    num_instances: int,
    preprocess_polys: List[List[Fp]],
    permutations: List[List[Tuple[int, int]]],
) -> PlonkishCircuitInfo:
    """util.rs:30-49: polys [pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o]."""
    pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o = [
        ex.Polynomial(Query(i, Rotation(0))) for i in range(9)
    ]
    return PlonkishCircuitInfo(
        k=num_vars,
        num_instances=[num_instances],
        preprocess_polys=preprocess_polys,
        num_witness_polys=[3],
        num_challenges=[0],
        constraints=[
            q_l * w_l + q_r * w_r + q_m * w_l * w_r + q_o * w_o + q_c + pi
        ],
        lookups=[],
        permutations=permutations,
        max_degree=4,
        field_spec=spec,
    )


def vanilla_plonk_expression(spec: FieldSpec, num_vars: int):
    """util.rs:51-61."""
    zeros = [[Fp.zero(spec)] * (1 << num_vars) for _ in range(5)]
    circuit_info = vanilla_plonk_circuit_info(
        spec, num_vars, 0, zeros, [[(6, 1)], [(7, 1)], [(8, 1)]]
    )
    num_z, expression = compose(circuit_info)
    assert num_z == 1
    return expression


def vanilla_plonk_with_lookup_circuit_info(
    spec: FieldSpec,
    num_vars: int,
    num_instances: int,
    preprocess_polys: List[List[Fp]],
    permutations: List[List[Tuple[int, int]]],
) -> PlonkishCircuitInfo:
    """util.rs:63-86: polys [pi, q_l, q_r, q_m, q_o, q_c, q_lookup,
    t_l, t_r, t_o, w_l, w_r, w_o]."""
    (pi, q_l, q_r, q_m, q_o, q_c, q_lookup, t_l, t_r, t_o, w_l, w_r, w_o) = [
        ex.Polynomial(Query(i, Rotation(0))) for i in range(13)
    ]
    return PlonkishCircuitInfo(
        k=num_vars,
        num_instances=[num_instances],
        preprocess_polys=preprocess_polys,
        num_witness_polys=[3],
        num_challenges=[0],
        constraints=[
            q_l * w_l + q_r * w_r + q_m * w_l * w_r + q_o * w_o + q_c + pi
        ],
        lookups=[[
            (q_lookup * w_l, t_l),
            (q_lookup * w_r, t_r),
            (q_lookup * w_o, t_o),
        ]],
        permutations=permutations,
        max_degree=4,
        field_spec=spec,
    )


def vanilla_plonk_with_lookup_expression(spec: FieldSpec, num_vars: int):
    zeros = [[Fp.zero(spec)] * (1 << num_vars) for _ in range(9)]
    circuit_info = vanilla_plonk_with_lookup_circuit_info(
        spec, num_vars, 0, zeros, [[(10, 1)], [(11, 1)], [(12, 1)]]
    )
    num_z, expression = compose(circuit_info)
    assert num_z == 1
    return expression


class Permutation:
    """Copy-constraint cycle builder (util.rs:376-405)."""

    def __init__(self):
        self.cycles: List[set] = []
        self.cycle_idx: Dict[Tuple[int, int], int] = {}

    def copy(self, lhs: Tuple[int, int], rhs: Tuple[int, int]) -> None:
        idx = self.cycle_idx.get(lhs)
        if idx is not None:
            self.cycles[idx].add(rhs)
            self.cycle_idx[rhs] = idx
        else:
            idx = len(self.cycles)
            self.cycles.append({lhs, rhs})
            self.cycle_idx[lhs] = idx
            self.cycle_idx[rhs] = idx

    def into_cycles(self) -> List[List[Tuple[int, int]]]:
        return [sorted(c) for c in self.cycles]


def rand_vanilla_plonk_circuit(
    spec: FieldSpec,
    num_vars: int,
    preprocess_rng: random.Random,
    witness_rng: random.Random,
):
    """Random valid vanilla-PLONK circuit + witness (util.rs:100-169)."""
    size = 1 << num_vars
    zero = Fp.zero(spec)
    one = Fp.one(spec)
    polys = [[zero] * size for _ in range(9)]

    instances = [Fp(witness_rng.randrange(spec.p), spec) for _ in range(num_vars)]
    mapping = row_mapping(num_vars)
    for b, v in zip(mapping, instances):
        polys[0][b] = v

    permutation = Permutation()
    for poly in (6, 7, 8):
        permutation.copy((poly, 1), (poly, 1))
    for idx in range(size - 1):
        if preprocess_rng.getrandbits(1) == 0 and idx > 1:
            l_copy = (preprocess_rng.randrange(6, 9), preprocess_rng.randrange(1, idx))
            r_copy = (preprocess_rng.randrange(6, 9), preprocess_rng.randrange(1, idx))
            permutation.copy(l_copy, (6, idx))
            permutation.copy(r_copy, (7, idx))
            w_l = polys[l_copy[0]][l_copy[1]]
            w_r = polys[r_copy[0]][r_copy[1]]
        else:
            w_l = Fp(witness_rng.randrange(spec.p), spec)
            w_r = Fp(witness_rng.randrange(spec.p), spec)
        q_c = Fp(preprocess_rng.randrange(spec.p), spec)
        if preprocess_rng.getrandbits(1) == 0:
            values = [
                (1, one), (2, one), (4, -one), (5, q_c),
                (6, w_l), (7, w_r),
                (8, w_l + w_r + q_c + polys[0][idx]),
            ]
        else:
            values = [
                (3, one), (4, -one), (5, q_c),
                (6, w_l), (7, w_r),
                (8, w_l * w_r + q_c + polys[0][idx]),
            ]
        for poly, value in values:
            polys[poly][idx] = value

    _, q_l, q_r, q_m, q_o, q_c_col, w_l_col, w_r_col, w_o_col = polys
    circuit_info = vanilla_plonk_circuit_info(
        spec,
        num_vars,
        len(instances),
        [q_l, q_r, q_m, q_o, q_c_col],
        permutation.into_cycles(),
    )
    return circuit_info, MockCircuit([instances], [w_l_col, w_r_col, w_o_col])


def rand_vanilla_plonk_with_lookup_circuit(
    spec: FieldSpec,
    num_vars: int,
    preprocess_rng: random.Random,
    witness_rng: random.Random,
):
    """util.rs:216-316."""
    size = 1 << num_vars
    zero = Fp.zero(spec)
    one = Fp.one(spec)
    polys = [[zero] * size for _ in range(13)]

    for t in (7, 8, 9):
        col = [zero, zero] + [
            Fp(preprocess_rng.randrange(spec.p), spec) for _ in range(size - 2)
        ]
        polys[t] = col

    instances = [Fp(witness_rng.randrange(spec.p), spec) for _ in range(num_vars)]
    mapping = row_mapping(num_vars)
    for b, v in zip(mapping, instances):
        polys[0][b] = v
    from ..utils.bh import BooleanHypercube

    instance_rows = set(
        list(BooleanHypercube(num_vars).iter())[: num_vars + 1]
    )

    permutation = Permutation()
    for poly in (10, 11, 12):
        permutation.copy((poly, 1), (poly, 1))
    for idx in range(size - 1):
        use_copy = preprocess_rng.getrandbits(1) == 0 and idx > 1
        if use_copy:
            l_copy = (preprocess_rng.randrange(10, 13), preprocess_rng.randrange(1, idx))
            r_copy = (preprocess_rng.randrange(10, 13), preprocess_rng.randrange(1, idx))
            permutation.copy(l_copy, (10, idx))
            permutation.copy(r_copy, (11, idx))
            w_l = polys[l_copy[0]][l_copy[1]]
            w_r = polys[r_copy[0]][r_copy[1]]
        else:
            w_l = Fp(witness_rng.randrange(spec.p), spec)
            w_r = Fp(witness_rng.randrange(spec.p), spec)
        q_c = Fp(preprocess_rng.randrange(spec.p), spec)
        if use_copy or idx in instance_rows:
            if preprocess_rng.getrandbits(1) == 0:
                values = [
                    (1, one), (2, one), (4, -one), (5, q_c),
                    (10, w_l), (11, w_r),
                    (12, w_l + w_r + q_c + polys[0][idx]),
                ]
            else:
                values = [
                    (3, one), (4, -one), (5, q_c),
                    (10, w_l), (11, w_r),
                    (12, w_l * w_r + q_c + polys[0][idx]),
                ]
        else:
            t_idx = witness_rng.randrange(1, size)
            values = [
                (6, one),
                (10, polys[7][t_idx]),
                (11, polys[8][t_idx]),
                (12, polys[9][t_idx]),
            ]
        for poly, value in values:
            polys[poly][idx] = value

    (_, q_l, q_r, q_m, q_o, q_c_col, q_lookup, t_l, t_r, t_o,
     w_l_col, w_r_col, w_o_col) = polys
    circuit_info = vanilla_plonk_with_lookup_circuit_info(
        spec,
        num_vars,
        len(instances),
        [q_l, q_r, q_m, q_o, q_c_col, q_lookup, t_l, t_r, t_o],
        permutation.into_cycles(),
    )
    return circuit_info, MockCircuit([instances], [w_l_col, w_r_col, w_o_col])
