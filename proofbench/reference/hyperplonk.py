"""The benchmark's plain HyperPlonk verifier over multilinear KZG.

Frozen copies of the host code of plonkish_tpu_torch (itself copied from the
upstream's hyperplonk.rs, preprocessor.rs, verifier.rs, the classic
sum-check and the additive batch open), on plain ints.  The one departure
is the last KZG check: the benchmark made the SRS and knows its trapdoor
s, so the pairing equation

    e(C - v G, -H) * prod_i e(Q_i, (s_i - x_i) H) == 1

is checked as the equal statement in G1, C - v G == sum_i (s_i - x_i) Q_i,
with no pairing.  A proof is accepted only if every check holds, the stream
is read to its end, and (where given) the witness commitments equal the
ones the reference worked out from the witness.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from . import expression as ex
from .bh import BooleanHypercube
from .curve import G1
from .expression import EqXY, Expression, Identity, Lagrange, Query, Rotation
from .field import FR, Fp, batch_invert
from .transcript import TranscriptReader


# ---------------------------------------------------------------------------
# Circuit description and the composed zero-check expression
# (preprocessor.rs:25-170)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CircuitInfo:
    k: int
    num_instances: List[int]
    num_preprocess_polys: int
    num_witness_polys: List[int]
    num_challenges: List[int]
    constraints: List[Expression]
    lookups: List
    permutation_polys: List[int]
    max_degree: Optional[int] = None

    def num_poly(self) -> int:
        return len(self.num_instances) + self.num_preprocess_polys + sum(self.num_witness_polys)


def vanilla_plonk_info(k: int, num_instances: int, permutation_polys: List[int]) -> CircuitInfo:
    """util.rs:30-49: polys [pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o]."""
    pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o = [
        ex.Polynomial(Query(i, Rotation(0))) for i in range(9)
    ]
    return CircuitInfo(
        k=k, num_instances=[num_instances], num_preprocess_polys=5,
        num_witness_polys=[3], num_challenges=[0],
        constraints=[q_l * w_l + q_r * w_r + q_m * w_l * w_r + q_o * w_o + q_c + pi],
        lookups=[], permutation_polys=sorted(permutation_polys), max_degree=4,
    )


def _div_ceil(a: int, b: int) -> int:
    return -(-a // b)


def _lookup_constraints(info: CircuitInfo, beta, gamma):
    m_offset = info.num_poly() + len(info.permutation_polys)
    h_offset = m_offset + len(info.lookups)
    constraints = []
    for lookup_idx, lookup in enumerate(info.lookups):
        m = ex.Polynomial(Query(m_offset + lookup_idx, Rotation(0)))
        h = ex.Polynomial(Query(h_offset + lookup_idx, Rotation(0)))
        inp = ex.distribute_powers([i for (i, _) in lookup], beta)
        tbl = ex.distribute_powers([t for (_, t) in lookup], beta)
        constraints.append(h * (inp + gamma) * (tbl + gamma) - (tbl + gamma) + m * (inp + gamma))
    sum_checks = [ex.Polynomial(Query(h_offset + i, Rotation(0))) for i in range(len(info.lookups))]
    return constraints, sum_checks


def _permutation_constraints(info: CircuitInfo, max_degree: int, beta, gamma,
                             num_builtin_witness_polys: int):
    perm_polys = info.permutation_polys
    chunk_size = max_degree - 1
    num_chunks = _div_ceil(len(perm_polys), chunk_size)
    permutation_offset = info.num_poly()
    z_offset = permutation_offset + len(perm_polys) + num_builtin_witness_polys
    polys = [ex.Polynomial(Query(idx, Rotation(0))) for idx in perm_polys]
    ids = [ex.Constant(Fp(idx << info.k, FR)) + ex.identity() for idx in range(len(polys))]
    permutations = [ex.Polynomial(Query(permutation_offset + i, Rotation(0)))
                    for i in range(len(perm_polys))]
    zs = [ex.Polynomial(Query(z_offset + i, Rotation(0))) for i in range(num_chunks)]
    z_0_next = ex.Polynomial(Query(z_offset, Rotation(1)))
    l_1 = ex.lagrange(1)
    one = ex.Constant(Fp.one(FR))
    constraints = []
    if zs:
        constraints.append(l_1 * (zs[0] - one))
    z_rhs_seq = zs[1:] + [z_0_next]
    for c in range(num_chunks):
        lo, hi = c * chunk_size, min((c + 1) * chunk_size, len(polys))
        lhs_prod = rhs_prod = None
        for i in range(lo, hi):
            lhs_term = polys[i] + beta * ids[i] + gamma
            rhs_term = polys[i] + beta * permutations[i] + gamma
            lhs_prod = lhs_term if lhs_prod is None else lhs_prod * lhs_term
            rhs_prod = rhs_term if rhs_prod is None else rhs_prod * rhs_term
        constraints.append(zs[c] * lhs_prod - z_rhs_seq[c] * rhs_prod)
    return num_chunks, constraints


def compose(info: CircuitInfo) -> Tuple[int, Expression]:
    """The single zero-check expression and the number of permutation z polys."""
    challenge_offset = sum(info.num_challenges)
    beta = ex.Challenge(challenge_offset)
    gamma = ex.Challenge(challenge_offset + 1)
    alpha = ex.Challenge(challenge_offset + 2)
    lookup_cons, lookup_zero_checks = _lookup_constraints(info, beta, gamma)
    md = max([c.degree() for c in info.constraints] + [c.degree() for c in lookup_cons]
             + ([info.max_degree] if info.max_degree is not None else []) + [2])
    num_z, permutation_cons = _permutation_constraints(info, md, beta, gamma, 2 * len(info.lookups))
    constraints = list(info.constraints) + lookup_cons + permutation_cons
    zero_check_on_every_row = ex.distribute_powers(constraints, alpha) * ex.eq_xy(0)
    return num_z, ex.distribute_powers(lookup_zero_checks + [zero_check_on_every_row], alpha)


# ---------------------------------------------------------------------------
# Host evaluation helpers (sum_check.rs:60-125, multilinear.rs:433-570)
# ---------------------------------------------------------------------------

def lagrange_eval(x: Sequence[Fp], b: int) -> Fp:
    acc = Fp.one(FR)
    for idx, x_i in enumerate(x):
        acc = acc * (x_i if (b >> idx) & 1 else Fp.one(FR) - x_i)
    return acc


def eq_xy_eval(x: Sequence[Fp], y: Sequence[Fp]) -> Fp:
    if len(x) != len(y) or not x:
        raise ValueError("eq_xy_eval needs two points of one length")
    acc = Fp.one(FR)
    for x_i, y_i in zip(x, y):
        acc = acc * ((x_i * y_i).double() + Fp.one(FR) - x_i - y_i)
    return acc


def eq_table(y: Sequence[Fp]) -> List[Fp]:
    """eq(y, b) for every b, index bit i <-> y_i."""
    out = [Fp.one(FR)]
    for y_i in reversed(list(y)):
        nxt = []
        for d in out:
            hi = d * y_i
            nxt += [d - hi, hi]
        out = nxt
    return out


def hypercube_row(num_vars: int, i: int) -> int:
    """The hypercube index b at position i of the cyclic order 0, 1, X, X^2,
    .. (bh.rs), walked from 1 by the shorter way round."""
    n = 1 << num_vars
    i %= n
    if i == 0:
        return 0
    e = i - 1
    if e > (n - 1) // 2:
        e -= n - 1  # X^(n-1) = 1
    return BooleanHypercube(num_vars).rotate(1, e)


def _identity_eval(x: Sequence[Fp]) -> Fp:
    acc = Fp.zero(FR)
    for i, x_i in enumerate(x):
        acc = acc + x_i * (1 << i)
    return acc


def evaluate(expression: Expression, num_vars: int, evals: Dict[Query, Fp],
             challenges: Sequence[Fp], ys: Sequence[Sequence[Fp]], x: Sequence[Fp]) -> Fp:
    identity = _identity_eval(x)
    lagranges = {i: lagrange_eval(x, hypercube_row(num_vars, i)) for i in expression.used_lagrange()}
    eq_xys = [eq_xy_eval(x, y) for y in ys]

    def common(cp):
        if isinstance(cp, Identity):
            return identity
        if isinstance(cp, Lagrange):
            return lagranges[cp.i]
        if isinstance(cp, EqXY):
            return eq_xys[cp.idx]
        raise TypeError(cp)

    return expression.evaluate(
        lambda c: c, common, lambda q: evals[q], lambda idx: challenges[idx],
        lambda a: -a, lambda a, b: a + b, lambda a, b: a * b, lambda a, s: a * s,
    )


def _coeff_pattern(num_vars: int, distance: int, next_: bool) -> List[int]:
    bh = BooleanHypercube(num_vars)
    remainder = (bh.primitive - (1 << num_vars)) if next_ else (bh.x_inv << distance)
    pattern = [0] * (1 << (distance - 1))
    for depth in range(distance - 1):
        step = 1 << (distance - depth - 1)
        half = step >> 1
        for start in range(0, len(pattern), step):
            for off in range(half):
                e, o = start + off, start + off + half
                rotated = pattern[e] << 1 if next_ else pattern[e] >> 1
                pattern[o] = rotated ^ remainder
                pattern[e] = rotated
    return pattern


def _point_pattern(num_vars: int, distance: int, next_: bool) -> List[int]:
    bh = BooleanHypercube(num_vars)
    remainder = bh.primitive if next_ else bh.x_inv
    pattern = [0] * (1 << distance)
    for depth in range(distance):
        step = 1 << (distance - depth)
        half = step >> 1
        for start in range(0, len(pattern), step):
            for off in range(half):
                e, o = start + off, start + off + half
                rotated = pattern[e] << 1 if next_ else pattern[e] >> 1
                pattern[o] = rotated ^ remainder
                pattern[e] = rotated
    return pattern


def rotation_eval(x: Sequence[Fp], rotation: Rotation, evals_for_rotation: Sequence[Fp]) -> Fp:
    if rotation.value == 0:
        return evals_for_rotation[0]
    num_vars, distance = len(x), rotation.distance
    if rotation.value < 0:
        pattern = _coeff_pattern(num_vars, distance, next_=False)
        nths = list(range(distance, 0, -1))
        xs = list(reversed(x[0:distance]))
    else:
        pattern = _coeff_pattern(num_vars, distance, next_=True)
        nths = list(range(num_vars - 1, num_vars - 1 + distance))
        xs = list(x[num_vars - distance:])
    evals = list(evals_for_rotation)
    for idx, (x_i, nth) in enumerate(zip(xs, nths)):
        bits = [(pattern[p] >> nth) & 1 for p in range(0, len(pattern), 1 << idx)]
        evals = [((e0 - e1) * x_i + e1) if bit else ((e1 - e0) * x_i + e0)
                 for bit, (e0, e1) in zip(bits, zip(evals[0::2], evals[1::2]))]
    return evals[0]


def rotation_eval_points(x: Sequence[Fp], rotation: Rotation) -> List[List[Fp]]:
    if rotation.value == 0:
        return [list(x)]
    one_, zero = Fp.one(FR), Fp.zero(FR)
    distance = rotation.distance
    num_x = len(x) - distance
    points = []
    if rotation.value < 0:
        xs = x[distance:]
        for pat in _point_pattern(len(x), distance, next_=False):
            pt = [(one_ - xs[i]) if (pat >> i) & 1 else xs[i] for i in range(num_x)]
            pt += [one_ if (pat >> (i + num_x)) & 1 else zero for i in range(distance)]
            points.append(pt)
    else:
        xs = x[:num_x]
        for pat in _point_pattern(len(x), distance, next_=True):
            pt = [one_ if (pat >> i) & 1 else zero for i in range(distance)]
            pt += [(one_ - xs[i]) if (pat >> (i + distance)) & 1 else xs[i] for i in range(num_x)]
            points.append(pt)
    return points


# ---------------------------------------------------------------------------
# Classic sum-check verifier (classic.rs:197-264, eval.rs, coeff.rs)
# ---------------------------------------------------------------------------

def _barycentric(values: List[Fp], x: Fp) -> Fp:
    points = [Fp(i, FR) for i in range(len(values))]
    weights = []
    for j, pj in enumerate(points):
        w = Fp.one(FR)
        for i, pi in enumerate(points):
            if i != j:
                w = w * (pj - pi)
        weights.append(w)
    weights = batch_invert(weights)
    coeffs = [c * w for c, w in zip(batch_invert([x - p for p in points]), weights)]
    sum_inv = sum(coeffs, Fp.zero(FR)).inv()
    acc = Fp.zero(FR)
    for c, e in zip(coeffs, values):
        acc = acc + c * e
    return acc * sum_inv


def verify_sum_check(num_vars: int, degree: int, sum_: Fp, tr: TranscriptReader,
                     coefficients: bool) -> Tuple[Fp, List[Fp]]:
    msgs, challenges = [], []
    for _ in range(num_vars):
        msgs.append(tr.read_field_elements(degree + 1))
        challenges.append(tr.squeeze_challenge())
    current = sum_
    for round_, (msg, challenge) in enumerate(zip(msgs, challenges)):
        if coefficients:
            msg_sum = msg[0].double()
            for c in msg[1:]:
                msg_sum = msg_sum + c
        else:
            msg_sum = msg[0] + msg[1]
        if current != msg_sum:
            raise ValueError(f"sum-check consistency failure at round {round_}")
        if coefficients:
            current = Fp.zero(FR)
            for c in reversed(msg):
                current = current * challenge + c
        else:
            current = _barycentric(msg, challenge)
    return current, challenges


# ---------------------------------------------------------------------------
# HyperPlonk verifier (hyperplonk.rs:280-362, verifier.rs:39-182)
# ---------------------------------------------------------------------------

def _instance_evals(num_vars, expression, instances, x):
    queries = [q for q in expression.used_query() if q.poly < len(instances)]
    n = 1 << num_vars
    out = []
    for query in queries:
        if query.rotation.value > 0:
            is_ = (list(range(-query.rotation.value, 0)) + list(range(1, n)))[: len(instances[query.poly])]
        else:
            start = 1 - query.rotation.value
            is_ = list(range(start, start + len(instances[query.poly])))
        acc = Fp.zero(FR)
        for value, i in zip(instances[query.poly], is_):
            acc = acc + value * lagrange_eval(x, hypercube_row(num_vars, i))
        out.append((query, acc))
    return out


def _verify_zero_check(num_vars, expression, instances, challenges, y, tr):
    x_eval, x = verify_sum_check(num_vars, expression.degree(), Fp.zero(FR), tr, coefficients=False)
    queries = sorted((q for q in expression.used_query() if q.poly >= len(instances)),
                     key=lambda q: (q.poly, q.rotation.value))
    evals_for_rotation, query_evals = [], {}
    for query in queries:
        efr = tr.read_field_elements(1 << query.rotation.distance)
        evals_for_rotation.append(efr)
        query_evals[query] = rotation_eval(x, query.rotation, efr)
    for query, value in _instance_evals(num_vars, expression, instances, x):
        query_evals[query] = value
    if evaluate(expression, num_vars, query_evals, challenges, [y], x) != x_eval:
        raise ValueError("Unmatched between sum_check output and query evaluation")
    rotations = sorted({q.rotation for q in queries}, key=lambda r: r.value)
    offsets, offset, points = {}, 0, []
    for rotation in rotations:
        offsets[rotation] = offset
        offset += 1 << rotation.distance
        points.extend(rotation_eval_points(x, rotation))
    evals = [(query.poly, offsets[query.rotation] + i, value)
             for query, efr in zip(queries, evals_for_rotation) for i, value in enumerate(efr)]
    return points, evals


def _kzg_check(comm, point: Sequence[Fp], value: Fp, quotients, trapdoor: Sequence[int]) -> None:
    """C - v G == sum_i (s_i - x_i) Q_i: the pairing equation, with s known."""
    lhs = G1.add(comm, G1.neg(G1.mul(G1.gen, value.v)))
    rhs = None
    for q, x_i, s_i in zip(quotients, point, trapdoor):
        rhs = G1.add(rhs, G1.mul(q, s_i - x_i.v))
    if lhs != rhs:
        raise ValueError("Invalid multilinear KZG open")


def _batch_verify(num_vars, comms, points, evals, tr, trapdoor):
    ell = max(1, (len(evals) - 1).bit_length()) if len(evals) > 1 else 0
    t = tr.squeeze_challenges(ell)
    eq_xt = eq_table(t) if t else [Fp.one(FR)]
    tilde_gs_sum = Fp.zero(FR)
    for (_, _, value), eq_i in zip(evals, eq_xt):
        tilde_gs_sum = tilde_gs_sum + value * eq_i
    g_prime_eval, challenges = verify_sum_check(num_vars, 2, tilde_gs_sum, tr, coefficients=True)
    eq_xy_evals = [eq_xy_eval(challenges, list(p)) for p in points]
    scalars = [eq_xy_evals[pt] * eq_i for (_, pt, _), eq_i in zip(evals, eq_xt)]
    g_prime_comm = G1.msm([s.v for s in scalars], [comms[poly] for (poly, _, _) in evals])
    quotients = [tr.read_point() for _ in range(num_vars)]
    _kzg_check(g_prime_comm, challenges, g_prime_eval, quotients, trapdoor)


@dataclasses.dataclass
class VerifierKey:
    """What the verifier holds: worked out by the reference from the
    circuit and the trapdoor, never taken from the program."""
    info: CircuitInfo
    expression: Expression
    num_permutation_z_polys: int
    preprocess_comms: list
    permutation_comms: list
    trapdoor: List[int]


def verifier_key(info: CircuitInfo, preprocess_comms, permutation_comms, trapdoor) -> VerifierKey:
    num_z, expression = compose(info)
    return VerifierKey(info, expression, num_z, list(preprocess_comms),
                       list(permutation_comms), list(trapdoor))


def verify(vk: VerifierKey, instances: Sequence[Sequence[int]], proof: bytes,
           witness_comms: Optional[Sequence] = None) -> None:
    """Raises ValueError (or EOFError) unless `proof` proves the circuit for
    `instances`; with `witness_comms`, also unless it commits to them."""
    info = vk.info
    instances = [[Fp(v, FR) for v in column] for column in instances]
    tr = TranscriptReader(FR, proof)
    for num, column in zip(info.num_instances, instances):
        if len(column) != num:
            raise ValueError("instance column length mismatch")
        for value in column:
            tr.common_field_element(value)
    comms_w, challenges = [], []
    for num_polys, num_challenges in zip(info.num_witness_polys, info.num_challenges):
        comms_w += [tr.read_point() for _ in range(num_polys)]
        challenges += tr.squeeze_challenges(num_challenges)
    if witness_comms is not None and list(witness_comms) != comms_w:
        raise ValueError("the witness commitments are not those of the witness handed in")
    beta = tr.squeeze_challenge()
    m_comms = [tr.read_point() for _ in range(len(info.lookups))]
    gamma = tr.squeeze_challenge()
    h_z_comms = [tr.read_point() for _ in range(len(info.lookups) + vk.num_permutation_z_polys)]
    alpha = tr.squeeze_challenge()
    y = tr.squeeze_challenges(info.k)
    points, evals = _verify_zero_check(info.k, vk.expression, instances,
                                       challenges + [beta, gamma, alpha], y, tr)
    comms = ([None] * len(info.num_instances) + vk.preprocess_comms + comms_w
             + vk.permutation_comms + m_comms + h_z_comms)
    _batch_verify(info.k, comms, points, evals, tr, vk.trapdoor)
    if not tr.at_end():
        raise ValueError("bytes left after the proof")
