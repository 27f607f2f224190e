# Copied from plonkish_tpu/frontend/builder.py; imports resolve inside plonkish_tpu_torch.
"""Circuit-builder frontend.

The reference's frontend adapts `halo2_proofs` circuits by replaying their
synthesis against collector assignments
(plonkish_backend/src/frontend/halo2.rs).  This framework is
standalone, so the frontend is a native row-assignment DSL with the same
semantics and the same column→polynomial flattening order (instances, fixed +
selectors, advice by phase — halo2.rs:650-677):

- columns: instance / fixed / selector / advice(phase);
- gates: expressions over column queries with rotations (user-row `next` is
  implemented by the boolean-hypercube cyclic mapping, so every assignment
  row r lands at BH position order[r+1] — halo2.rs row_mapping semantics);
- lookups: (input expr, table expr) column tuples;
- copy constraints: equality cycles between cells.

`build()` produces a `PlonkishCircuitInfo` + `PlonkishCircuit` consumable by
HyperPlonk and Protostar.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..backend.circuit import PlonkishCircuit, PlonkishCircuitInfo
from ..backend.hyperplonk.prover import row_mapping
from ..fields.host import Fp
from ..fields.spec import BN254_FR, FieldSpec
from ..utils import expression as ex
from ..utils.expression import Expression, Query, Rotation


@dataclasses.dataclass(frozen=True)
class Column:
    kind: str  # "instance" | "fixed" | "advice"
    index: int  # index within its kind (advice: global advice index)
    phase: int = 0

    def cur(self) -> "ColumnQuery":
        return ColumnQuery(self, 0)

    def next(self) -> "ColumnQuery":
        return ColumnQuery(self, 1)

    def prev(self) -> "ColumnQuery":
        return ColumnQuery(self, -1)

    def rot(self, rotation: int) -> "ColumnQuery":
        return ColumnQuery(self, rotation)


@dataclasses.dataclass(frozen=True)
class ColumnQuery:
    column: Column
    rotation: int


@dataclasses.dataclass(frozen=True)
class Cell:
    column: Column
    row: int


@dataclasses.dataclass(frozen=True)
class ChallengeHandle:
    """A Fiat–Shamir challenge squeezed after the given phase's witness
    commitments (halo2.rs:55-91 captures these from the constraint system;
    here they are first-class builder objects)."""

    index: int  # creation order
    phase: int


class CircuitBuilder:
    """Collects circuit structure; `build` freezes it into backend inputs."""

    def __init__(self, k: int, spec: FieldSpec = BN254_FR):
        self.k = k
        self.spec = spec
        self.num_rows = 1 << k
        self._instance_sizes: List[int] = []
        self._num_fixed = 0
        self._advice_phases: List[int] = []
        self._challenge_phases: List[int] = []
        self._gates: List[Tuple[str, Callable]] = []
        self._lookups: List[List[Tuple[object, object]]] = []
        self._copies: List[Tuple[Cell, Cell]] = []
        self.max_degree: Optional[int] = None

    # ---- columns ----
    def instance_column(self, num_values: int) -> Column:
        col = Column("instance", len(self._instance_sizes))
        self._instance_sizes.append(num_values)
        return col

    def fixed_column(self) -> Column:
        col = Column("fixed", self._num_fixed)
        self._num_fixed += 1
        return col

    selector = fixed_column

    def advice_column(self, phase: int = 0) -> Column:
        col = Column("advice", len(self._advice_phases), phase)
        self._advice_phases.append(phase)
        return col

    def challenge(self, phase: int = 0) -> ChallengeHandle:
        """Declare a challenge available after the phase-`phase` witness
        columns are committed.  Usable in gate/lookup expressions and (via
        `challenge_index`) by later-phase `witness_fn` calls
        (halo2.rs:585-648 phase-indexed challenge layout)."""
        handle = ChallengeHandle(len(self._challenge_phases), phase)
        self._challenge_phases.append(phase)
        return handle

    def challenge_index(self, handle: ChallengeHandle) -> int:
        """Flattened (phase-major) index of a challenge — the position in
        the `challenges` list handed to `witness_fn` and to expressions."""
        earlier = sum(1 for p in self._challenge_phases if p < handle.phase)
        within = sum(
            1
            for i, p in enumerate(self._challenge_phases)
            if p == handle.phase and i < handle.index
        )
        return earlier + within

    # ---- structure ----
    def gate(self, name: str, expr) -> None:
        """expr: an Expression over ColumnQuery/Column leaves (via query())
        or a callable returning one."""
        self._gates.append((name, expr))

    def lookup(self, name: str, pairs: Sequence[Tuple[object, object]]) -> None:
        self._lookups.append(list(pairs))

    def copy(self, a: Cell, b: Cell) -> None:
        """Equality-constrain two cells (permutation argument)."""
        self._copies.append((a, b))

    # ---- flattening (column -> poly index; halo2.rs:650-677 order) ----
    def _num_phases(self) -> int:
        return max(self._advice_phases, default=0) + 1

    def _advice_flat_index(self, advice_idx: int) -> int:
        """Advice columns are laid out grouped by phase."""
        phase = self._advice_phases[advice_idx]
        earlier_phases = sum(
            1 for p in self._advice_phases if p < phase
        )
        within = sum(
            1
            for i, p in enumerate(self._advice_phases)
            if p == phase and i < advice_idx
        )
        return earlier_phases + within

    def poly_index(self, column: Column) -> int:
        ni = len(self._instance_sizes)
        if column.kind == "instance":
            return column.index
        if column.kind == "fixed":
            return ni + column.index
        return ni + self._num_fixed + self._advice_flat_index(column.index)

    def query(self, q) -> Expression:
        if isinstance(q, Column):
            q = q.cur()
        if isinstance(q, ColumnQuery):
            return ex.Polynomial(
                Query(self.poly_index(q.column), Rotation(q.rotation))
            )
        if isinstance(q, ChallengeHandle):
            return ex.Challenge(self.challenge_index(q))
        if isinstance(q, Expression):
            return q
        if isinstance(q, (int, Fp)):
            return ex.Constant(
                q if isinstance(q, Fp) else Fp(q, self.spec)
            )
        raise TypeError(q)

    def _to_expression(self, e) -> Expression:
        if callable(e) and not isinstance(e, Expression):
            e = e(self.query)
        return self.query(e)

    # ---- build ----
    def build(
        self,
        fixed_assignments: Dict[Tuple[int, int], Fp],
        instances: List[List[Fp]],
        witness_fn: Callable,
    ) -> Tuple[PlonkishCircuitInfo, "BuiltCircuit"]:
        """fixed_assignments: {(fixed col index, user row): value}.
        witness_fn(phase, challenges) -> {(advice col index, user row): value}.
        """
        spec = self.spec
        n = self.num_rows
        mapping = row_mapping(self.k)

        preprocess = [
            [Fp.zero(spec)] * n for _ in range(self._num_fixed)
        ]
        for (col, row), value in fixed_assignments.items():
            preprocess[col][mapping[row]] = value

        constraints = [self._to_expression(e) for _, e in self._gates]
        lookups = [
            [
                (self._to_expression(i), self._to_expression(t))
                for (i, t) in lookup
            ]
            for lookup in self._lookups
        ]

        # permutation cycles over flattened poly indices + BH rows
        from ..models.circuits import Permutation

        permutation = Permutation()
        copied_polys = sorted(
            {self.poly_index(c.column) for pair in self._copies for c in pair}
        )
        for poly in copied_polys:
            # seed each poly into the cycle structure (mirrors the reference
            # generators seeding (poly,1),(poly,1))
            permutation.copy((poly, 1), (poly, 1))
        for a, b in self._copies:
            pa = (self.poly_index(a.column), mapping[a.row])
            pb = (self.poly_index(b.column), mapping[b.row])
            assert pa[1] != 0 and pb[1] != 0, (
                "the last user row maps to hypercube row 0 and cannot be "
                "copy-constrained"
            )
            permutation.copy(pa, pb)

        num_phases = self._num_phases()
        num_witness_polys = [
            sum(1 for p in self._advice_phases if p == phase)
            for phase in range(num_phases)
        ]
        num_phases = max(
            num_phases, max(self._challenge_phases, default=-1) + 1
        )
        num_witness_polys = num_witness_polys + [0] * (
            num_phases - len(num_witness_polys)
        )
        num_challenges = [
            sum(1 for p in self._challenge_phases if p == phase)
            for phase in range(num_phases)
        ]

        info = PlonkishCircuitInfo(
            k=self.k,
            num_instances=list(self._instance_sizes),
            preprocess_polys=preprocess,
            num_witness_polys=num_witness_polys,
            num_challenges=num_challenges,
            constraints=constraints,
            lookups=lookups,
            permutations=permutation.into_cycles(),
            max_degree=self.max_degree
            or max((c.degree() for c in constraints), default=2),
            field_spec=spec,
        )
        circuit = BuiltCircuit(self, info, instances, witness_fn)
        return info, circuit


class BuiltCircuit(PlonkishCircuit):
    def __init__(self, builder: CircuitBuilder, info, instances, witness_fn):
        self.builder = builder
        self.info = info
        self._instances = instances
        self.witness_fn = witness_fn

    def circuit_info(self):
        return self.info

    def circuit_info_without_preprocess(self):
        return self.info

    def instances(self):
        return self._instances

    def synthesize(self, round_: int, challenges):
        spec = self.builder.spec
        n = self.builder.num_rows
        mapping = row_mapping(self.builder.k)
        assignments = self.witness_fn(round_, challenges)
        phase_cols = [
            i
            for i, p in enumerate(self.builder._advice_phases)
            if p == round_
        ]
        col_order = {c: j for j, c in enumerate(phase_cols)}
        out = [[Fp.zero(spec)] * n for _ in phase_cols]
        for (col, row), value in assignments.items():
            out[col_order[col]][mapping[row]] = value
        return out
