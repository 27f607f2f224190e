# Copied from plonkish_tpu/backend/hyperplonk/verifier.py; imports resolve inside plonkish_tpu_torch.
"""HyperPlonk verifier helpers (host-side, O(k·d + #queries) field ops).

Mirrors plonkish_backend/src/backend/hyperplonk/verifier.rs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from ...fields.host import Fp
from ...fields.spec import FieldSpec
from ...piop.sum_check import (
    ClassicSumCheck,
    evaluate,
    lagrange_eval,
)
from ...poly.multilinear import rotation_eval, rotation_eval_points
from ...utils.bh import BooleanHypercube
from ...utils.expression import Expression, Query, Rotation
from ...utils.transcript import Keccak256Transcript
from ..pcs_api import Evaluation


def pcs_query(expression: Expression, num_instance_poly: int) -> List[Query]:
    """Sorted non-instance queries (verifier.rs:147-154)."""
    queries = [
        q for q in expression.used_query() if q.poly >= num_instance_poly
    ]
    return sorted(queries, key=lambda q: (q.poly, q.rotation.value))


def _sorted_rotations(queries: Sequence[Query]) -> List[Rotation]:
    return sorted({q.rotation for q in queries}, key=lambda r: r.value)


def points(queries: Sequence[Query], x: Sequence[Fp]) -> List[List[Fp]]:
    """Dedup (by rotation) evaluation points (verifier.rs:156-164)."""
    out = []
    for rotation in _sorted_rotations(queries):
        out.extend(rotation_eval_points(x, rotation))
    return out


def point_offset(queries: Sequence[Query]) -> Dict[Rotation, int]:
    """Start index of each rotation's point block (verifier.rs:166-182)."""
    offsets = {}
    offset = 0
    for rotation in _sorted_rotations(queries):
        offsets[rotation] = offset
        offset += 1 << rotation.distance
    return offsets


def instance_evals(
    spec: FieldSpec,
    num_vars: int,
    expression: Expression,
    instances: Sequence[Sequence[Fp]],
    x: Sequence[Fp],
) -> List[Tuple[Query, Fp]]:
    """Evaluations of instance polynomials at x (verifier.rs:92-145):
    inner product of instance values with Lagrange evals at shifted rows."""
    instance_queries = [
        q for q in expression.used_query() if q.poly < len(instances)
    ]
    bh = BooleanHypercube(num_vars)
    order = bh.iter_array
    n = 1 << num_vars

    # collect all lagrange indices needed
    needed = set()
    index_lists = {}
    for query in instance_queries:
        if query.rotation.value > 0:
            is_ = list(range(-query.rotation.value, 0)) + list(range(1, n))
            is_ = is_[: len(instances[query.poly])]
        else:
            start = 1 - query.rotation.value
            is_ = list(range(start, start + len(instances[query.poly])))
        index_lists[query] = is_
        needed.update(is_)

    lagrange_evals = {}
    for i in needed:
        if i == 0:
            continue
        b = int(order[i % n])
        lagrange_evals[i] = lagrange_eval(x, b)

    out = []
    for query in instance_queries:
        acc = Fp.zero(spec)
        for value, i in zip(instances[query.poly], index_lists[query]):
            acc = acc + value * lagrange_evals[i]
        out.append((query, acc))
    return out


def verify_zero_check(
    spec: FieldSpec,
    num_vars: int,
    expression: Expression,
    instances: Sequence[Sequence[Fp]],
    challenges: Sequence[Fp],
    y: Sequence[Fp],
    transcript: Keccak256Transcript,
) -> Tuple[List[List[Fp]], List[Evaluation]]:
    return verify_sum_check(
        spec,
        num_vars,
        expression,
        Fp.zero(spec),
        instances,
        challenges,
        y,
        transcript,
    )


def verify_sum_check(
    spec: FieldSpec,
    num_vars: int,
    expression: Expression,
    sum_: Fp,
    instances: Sequence[Sequence[Fp]],
    challenges: Sequence[Fp],
    y: Sequence[Fp],
    transcript: Keccak256Transcript,
) -> Tuple[List[List[Fp]], List[Evaluation]]:
    """verifier.rs:39-90."""
    x_eval, x = ClassicSumCheck.evaluations().verify(
        spec, num_vars, expression.degree(), sum_, transcript
    )

    queries = pcs_query(expression, len(instances))
    evals_for_rotation = []
    query_evals = {}
    for query in queries:
        efr = transcript.read_field_elements(1 << query.rotation.distance)
        evals_for_rotation.append(efr)
        query_evals[query] = rotation_eval(x, query.rotation, efr)

    for query, eval_ in instance_evals(spec, num_vars, expression, instances, x):
        query_evals[query] = eval_

    if evaluate(expression, num_vars, query_evals, challenges, [y], x) != x_eval:
        raise ValueError(
            "Unmatched between sum_check output and query evaluation"
        )

    offsets = point_offset(queries)
    out_evals = []
    for query, efr in zip(queries, evals_for_rotation):
        for i, eval_ in enumerate(efr):
            out_evals.append(
                Evaluation(query.poly, offsets[query.rotation] + i, eval_)
            )
    return points(queries, x), out_evals
