# Copied from plonkish_tpu/backend/circuit.py; imports resolve inside plonkish_tpu_torch.
"""Plonkish circuit description and witness-provider interfaces.

Mirrors plonkish_backend/src/backend.rs:46-140:
`PlonkishCircuitInfo` (static circuit description) and `PlonkishCircuit`
(phase-wise witness synthesis callback), plus `MockCircuit` for tests.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..fields.host import Fp
from ..utils.expression import Expression


@dataclasses.dataclass
class PlonkishCircuitInfo:
    k: int
    num_instances: List[int]
    preprocess_polys: List[List[Fp]]  # each of length 2^k
    num_witness_polys: List[int]  # per phase
    num_challenges: List[int]  # per phase
    constraints: List[Expression]
    # each lookup: list of (input expr, table expr) column pairs
    lookups: List[List[Tuple[Expression, Expression]]]
    # each permutation cycle: list of (poly index, row) cells
    permutations: List[List[Tuple[int, int]]]
    max_degree: Optional[int] = None
    field_spec: Optional[object] = None  # FieldSpec; defaults to BN254 Fr

    def num_poly(self) -> int:
        return (
            len(self.num_instances)
            + len(self.preprocess_polys)
            + sum(self.num_witness_polys)
        )

    def permutation_polys(self) -> List[int]:
        seen = sorted(
            {poly for cycle in self.permutations for (poly, _) in cycle}
        )
        return seen

    def expressions(self):
        for c in self.constraints:
            yield c
        for lookup in self.lookups:
            for (inp, table) in lookup:
                yield inp
                yield table

    def is_well_formed(self) -> bool:
        num_poly = self.num_poly()
        num_challenges = sum(self.num_challenges)
        polys = set()
        for e in self.expressions():
            polys |= e.used_poly()
        polys |= set(self.permutation_polys())
        challenges = set()
        for e in self.expressions():
            challenges |= e.used_challenge()
        if len(self.num_witness_polys) != len(self.num_challenges):
            return False
        if any(n == 0 for n in self.num_witness_polys):
            return False
        if any(n == 0 for n in self.num_challenges[:-1]):
            return False
        if polys and max(polys) >= num_poly:
            return False
        if challenges and max(challenges) >= num_challenges:
            return False
        if self.max_degree is not None:
            if any(c.degree() > self.max_degree for c in self.constraints):
                return False
        return True


class PlonkishCircuit:
    def circuit_info(self) -> PlonkishCircuitInfo:
        raise NotImplementedError

    def circuit_info_without_preprocess(self) -> PlonkishCircuitInfo:
        raise NotImplementedError

    def instances(self) -> List[List[Fp]]:
        raise NotImplementedError

    def synthesize(self, round_: int, challenges: List[Fp]) -> List[List[Fp]]:
        """Witness columns for the given phase."""
        raise NotImplementedError


class MockCircuit(PlonkishCircuit):
    """Canned instances + single-phase witness (backend.rs:146-185)."""

    def __init__(self, instances: List[List[Fp]], witnesses: List[List[Fp]]):
        self._instances = instances
        self._witnesses = witnesses

    def instances(self):
        return self._instances

    def synthesize(self, round_, challenges):
        assert round_ == 0 and not challenges
        return self._witnesses
