"""Classic sum-check PIOP on torch tensors (port of plonkish_tpu/piop/sum_check.py).

Protocol semantics are those of the reference's host-transcript path
(sum_check.py:327-357 and :854-897): per round the prover sends the round
polynomial's evaluations at t = 0..d (``EvaluationsProver``) or its
coefficients (``CoefficientsProver``, the degree-2 batch-open rounds), the
verifier squeezes a challenge on the host transcript, and every live table is
folded with fix_var.

All live tables of a prove are one stacked Montgomery tensor ``int32[T, n, 8]``
(natural hypercube order, sorted table keys as in the reference's jax path):
the zero-check round message is one call of K3 (``kernels.sumcheck.round_evals``)
over a compiled expression tape, and the fold of every table is one call of K4
(``kernels.sumcheck.fold``).  The degree-2 rounds are plain torch over the
field layer.  Host functions below the state (verifier algebra, barycentric
interpolation, round messages) are copied from the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..fields import limb
from ..fields.host import Fp, batch_invert
from ..fields.spec import FieldSpec
from ..kernels import sumcheck as ksc
from ..poly.multilinear import MLPoly, eq_xy_evals
from ..utils.bh import BooleanHypercube
from ..utils.expression import (
    CommonPoly,
    EqXY,
    Expression,
    Identity,
    Lagrange,
    Polynomial,
    Query,
)
from ..utils.timer import span
from ..utils.transcript import Keccak256Transcript
from . import tape as tape_mod


# ---------------------------------------------------------------------------
# Virtual polynomial
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VirtualPolynomial:
    expression: Expression
    polys: List[MLPoly]
    challenges: List[Fp]
    ys: List[List[Fp]]


# ---------------------------------------------------------------------------
# Verifier-side final evaluation helpers (sum_check.rs:60-125)
# ---------------------------------------------------------------------------

def lagrange_eval(x: Sequence[Fp], b: int) -> Fp:
    assert len(x) > 0
    spec = x[0].spec
    acc = Fp.one(spec)
    for idx, x_i in enumerate(x):
        acc = acc * (x_i if (b >> idx) & 1 else Fp.one(spec) - x_i)
    return acc


def eq_xy_eval(x: Sequence[Fp], y: Sequence[Fp]) -> Fp:
    assert len(x) == len(y) and len(x) > 0
    spec = x[0].spec
    acc = Fp.one(spec)
    for x_i, y_i in zip(x, y):
        acc = acc * ((x_i * y_i).double() + Fp.one(spec) - x_i - y_i)
    return acc


def identity_eval(x: Sequence[Fp]) -> Fp:
    spec = x[0].spec
    acc = Fp.zero(spec)
    for i, x_i in enumerate(x):
        acc = acc + x_i * (1 << i)
    return acc


def evaluate(
    expression: Expression,
    num_vars: int,
    evals: Dict[Query, Fp],
    challenges: Sequence[Fp],
    ys: Sequence[Sequence[Fp]],
    x: Sequence[Fp],
) -> Fp:
    """Evaluate the expression at point x given query evals (host)."""
    assert num_vars > 0
    assert expression.max_used_rotation_distance() <= num_vars
    identity = identity_eval(x)
    bh = BooleanHypercube(num_vars)
    order = bh.iter_array
    lagranges = {}
    for i in expression.used_lagrange():
        b = int(order[i % (1 << num_vars)])
        lagranges[i] = lagrange_eval(x, b)
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
        lambda c: c,
        common,
        lambda q: evals[q],
        lambda idx: challenges[idx],
        lambda a: -a,
        lambda a, b: a + b,
        lambda a, b: a * b,
        lambda a, s: a * s,
    )


# ---------------------------------------------------------------------------
# Barycentric interpolation over points 0..d (arithmetic.rs:108-136)
# ---------------------------------------------------------------------------

def barycentric_weights(points: List[Fp]) -> List[Fp]:
    spec = points[0].spec
    weights = []
    for j, pj in enumerate(points):
        w = Fp.one(spec)
        for i, pi in enumerate(points):
            if i != j:
                w = w * (pj - pi)
        weights.append(w)
    return batch_invert(weights)


def barycentric_interpolate(
    weights: List[Fp], points: List[Fp], evals: List[Fp], x: Fp
) -> Fp:
    spec = x.spec
    coeffs = batch_invert([x - p for p in points])
    coeffs = [c * w for c, w in zip(coeffs, weights)]
    sum_inv = sum(coeffs, Fp.zero(spec)).inv()
    acc = Fp.zero(spec)
    for c, e in zip(coeffs, evals):
        acc = acc + c * e
    return acc * sum_inv




# ---------------------------------------------------------------------------
# Prover state
# ---------------------------------------------------------------------------

class ProverState:
    """Live tables of the classic sum-check prover (classic.rs:25-150), with
    dense Lagrange one-hots and rotations materialised by a BH gather at
    round 0, stacked into one tensor."""

    def __init__(self, spec: FieldSpec, num_vars: int, sum_: Fp,
                 virtual_poly: VirtualPolynomial):
        assert num_vars > 0
        assert virtual_poly.expression.max_used_rotation_distance() <= num_vars
        self.spec = spec
        self.num_vars = num_vars
        self.expression = virtual_poly.expression
        self.degree = virtual_poly.expression.degree()
        self.sum = sum_
        self.challenges = virtual_poly.challenges
        self.round = 0
        self.identity_offset = Fp.zero(spec)

        device = virtual_poly.polys[0].device
        self.device = device
        bh = BooleanHypercube(num_vars)
        n = 1 << num_vars
        tables = {}
        for i in self.expression.used_lagrange():
            vec = limb.zeros((n,), device)
            vec[int(bh.iter_array[i % n])] = limb.one(spec, (), device)
            tables[("lagrange", i)] = vec
        for i, y in enumerate(virtual_poly.ys):
            tables[("eq_xy", i)] = eq_xy_evals(spec, y, device)
        for idx, poly in enumerate(virtual_poly.polys):
            tables[("poly", idx, 0)] = poly.evals
        for query in self.expression.used_query():
            rot = query.rotation.value
            if rot != 0 and ("poly", query.poly, rot) not in tables:
                rmap = torch.as_tensor(bh.rotation_map(rot), device=device)
                tables[("poly", query.poly, rot)] = virtual_poly.polys[query.poly].evals[rmap]
        self.table_keys = tuple(sorted(tables))
        self.stacked = torch.stack([tables[k] for k in self.table_keys], dim=0)

    @property
    def size(self) -> int:
        return 1 << (self.num_vars - self.round - 1)

    def table(self, key) -> torch.Tensor:
        return self.stacked[self.table_keys.index(key)]

    def next_round(self, sum_: Fp, challenge: Fp) -> None:
        self.sum = sum_
        self.identity_offset = self.identity_offset + challenge * (1 << self.round)
        c = limb.const(self.spec, int(challenge), self.device)
        self.stacked = ksc.fold(self.spec, self.stacked, c)
        self.round += 1

    def into_evals(self) -> List[Fp]:
        """Final evaluations of each input poly at the challenge point."""
        assert self.round == self.num_vars
        rows = [i for i, k in enumerate(self.table_keys) if k[0] == "poly" and k[2] == 0]
        vals = limb.to_canonical_ints(self.spec, self.stacked[rows])
        return [Fp(v, self.spec) for v in vals]


def identity_params(spec: FieldSpec, round_: int, offset: Fp, device):
    """(mul, base, step) of the identity leaf at this round: value at pair i
    and t is offset + 2^r + i * 2^(r+1) + (t - 1) * 2^r (eval.rs:233-236)."""
    mul = ((1 << (round_ + 1)) * spec.r2_mod_p) % spec.p
    return (
        limb.from_ints([mul], device)[0],
        limb.const(spec, int(offset) + (1 << round_), device),
        limb.const(spec, 1 << round_, device),
    )


# ---------------------------------------------------------------------------
# Round messages
# ---------------------------------------------------------------------------

class Evaluations:
    """Round poly as evals at t=0..d (classic/eval.rs:22-68)."""

    def __init__(self, values: List[Fp]):
        self.values = values

    def write(self, transcript: Keccak256Transcript) -> None:
        transcript.write_field_elements(self.values)

    @staticmethod
    def read(degree: int, transcript: Keccak256Transcript) -> "Evaluations":
        return Evaluations(transcript.read_field_elements(degree + 1))

    def sum(self) -> Fp:
        return self.values[0] + self.values[1]

    @staticmethod
    def auxiliary(degree: int, spec: FieldSpec):
        points = [Fp(i, spec) for i in range(degree + 1)]
        return (barycentric_weights(points), points)

    def evaluate(self, aux, challenge: Fp) -> Fp:
        weights, points = aux
        return barycentric_interpolate(weights, points, self.values, challenge)


class Coefficients:
    """Round poly as coefficients (classic/coeff.rs:16-39)."""

    def __init__(self, values: List[Fp]):
        self.values = values

    def write(self, transcript: Keccak256Transcript) -> None:
        transcript.write_field_elements(self.values)

    @staticmethod
    def read(degree: int, transcript: Keccak256Transcript) -> "Coefficients":
        return Coefficients(transcript.read_field_elements(degree + 1))

    def sum(self) -> Fp:
        acc = self.values[0].double()
        for c in self.values[1:]:
            acc = acc + c
        return acc

    @staticmethod
    def auxiliary(degree: int, spec: FieldSpec):
        return None

    def evaluate(self, aux, challenge: Fp) -> Fp:
        acc = Fp.zero(challenge.spec)
        for c in reversed(self.values):
            acc = acc * challenge + c
        return acc




# ---------------------------------------------------------------------------
# EvaluationsProver (zero-check rounds: kernels K3 + K4)
# ---------------------------------------------------------------------------

class EvaluationsProver:
    """General-degree prover: the round polynomial's evaluations at t = 1..d
    from one K3 call over the expression tape."""

    def __init__(self, state: ProverState):
        spec = state.spec
        self.expr = state.expression.simplified(state.challenges)
        t = tape_mod.compile_tape(self.expr, spec)
        row_of = {k: i for i, k in enumerate(state.table_keys)}
        row_of[("identity",)] = len(state.table_keys)
        instrs = t.instrs.copy()
        is_load = instrs[:, 0] == tape_mod.OP_LOAD
        instrs[is_load, 1] = np.asarray(
            [row_of[k] for k in t.leaf_keys], dtype=np.int32
        )[instrs[is_load, 1]]
        self.tape = t
        self.instrs = instrs
        self.consts = t.const_rows(spec, state.device)

    def prove_round(self, state: ProverState) -> Evaluations:
        spec = state.spec
        d = state.degree
        ids = identity_params(spec, state.round, state.identity_offset, state.device)
        sums = ksc.round_evals(
            spec, state.stacked, self.instrs, self.consts, self.tape.num_regs,
            self.tape.out_reg, d, ids,
        )
        vals = limb.to_canonical_ints(spec, sums)
        evals = [Fp.zero(spec)] + [Fp(v, spec) for v in vals]
        evals[0] = state.sum - evals[1]
        return Evaluations(evals)


# ---------------------------------------------------------------------------
# CoefficientsProver (degree-2 batch-open rounds, plain torch)
# ---------------------------------------------------------------------------

class CoefficientsProver:
    """Flattens the expression to constant + sum scalar * eq_xy * poly and
    runs the karatsuba round (coeff.rs:66-208)."""

    def __init__(self, state: ProverState):
        spec = state.spec
        challenges = state.challenges

        def constant(c):
            return (c, [])

        def common(cp):
            return (Fp.zero(spec), [(Fp.one(spec), [CommonPoly(cp)])])

        def poly(q):
            return (Fp.zero(spec), [(Fp.one(spec), [Polynomial(q)])])

        def challenge(idx):
            return (challenges[idx], [])

        def negated(v):
            c, prods = v
            return (-c, [(-s, ps) for s, ps in prods])

        def sum_(a, b):
            return (a[0] + b[0], a[1] + b[1])

        def product(a, b):
            (ca, pa), (cb, pb) = a, b
            out = []
            if ca != 0:
                out.extend((ca * s, ps) for s, ps in pb)
            if cb != 0:
                out.extend((cb * s, ps) for s, ps in pa)
            for (sa, psa) in pa:
                for (sb, psb) in pb:
                    out.append((sa * sb, psa + psb))
            return (ca * cb, out)

        def scaled(v, s):
            c, prods = v
            return (c * s, [(x * s, ps) for x, ps in prods])

        self.constant, self.flattened = state.expression.evaluate(
            constant, common, poly, challenge, negated, sum_, product, scaled
        )
        assert all(len(ps) == 2 for _, ps in self.flattened), (
            "CoefficientsProver supports degree-2 eq_xy * poly expressions"
        )

    def term_triples(self):
        """(eq_idx, poly_idx, scalar int) per flattened term (coeff.rs:157-167)."""
        out = []
        for scalar, prods in self.flattened:
            lhs, rhs = prods
            if isinstance(lhs, CommonPoly):
                eq_idx, query = lhs.poly.idx, rhs.query
            else:
                eq_idx, query = rhs.poly.idx, lhs.query
            assert query.rotation.value == 0
            out.append((eq_idx, query.poly, int(scalar)))
        return out

    def prove_round(self, state: ProverState) -> Coefficients:
        spec = state.spec
        size = state.size
        c0 = Fp(size, spec) * self.constant
        c2 = Fp.zero(spec)
        triples = self.term_triples()
        if triples:
            c = limb._consts(spec, state.device)
            acc0 = acc2 = None
            for eq_idx, poly_idx, scalar in triples:
                eq = limb.unpack(state.table(("eq_xy", eq_idx)))
                p = limb.unpack(state.table(("poly", poly_idx, 0)))
                eq_lo, eq_hi = eq[:, 0::2], eq[:, 1::2]
                p_lo, p_hi = p[:, 0::2], p[:, 1::2]
                s = limb.d_const(spec, scalar, state.device)
                lo = limb.d_sum(limb.d_mul(eq_lo, p_lo, c), c)
                diff = limb.d_mul(limb.d_sub(eq_hi, eq_lo, c), limb.d_sub(p_hi, p_lo, c), c)
                hi = limb.d_sum(diff, c)
                t0, t2 = limb.d_mul(lo, s, c), limb.d_mul(hi, s, c)
                acc0 = t0 if acc0 is None else limb.d_add(acc0, t0, c)
                acc2 = t2 if acc2 is None else limb.d_add(acc2, t2, c)
            v0, v2 = limb.to_canonical_ints(spec, limb.pack(torch.cat([acc0, acc2], 1)))
            c0 = c0 + Fp(v0, spec)
            c2 = c2 + Fp(v2, spec)
        c1 = state.sum - c0.double() - c2
        return Coefficients([c0, c1, c2])


# ---------------------------------------------------------------------------
# ClassicSumCheck driver
# ---------------------------------------------------------------------------

class ClassicSumCheck:
    """prove/verify loop (classic.rs:197-264)."""

    def __init__(self, prover_cls, message_cls):
        self.prover_cls = prover_cls
        self.message_cls = message_cls

    @classmethod
    def evaluations(cls):
        return cls(EvaluationsProver, Evaluations)

    @classmethod
    def coefficients(cls):
        return cls(CoefficientsProver, Coefficients)

    def prove(
        self,
        spec: FieldSpec,
        num_vars: int,
        virtual_poly: VirtualPolynomial,
        sum_: Fp,
        transcript: Keccak256Transcript,
    ) -> Tuple[List[Fp], List[Fp]]:
        with span(f"sum_check_prove-{num_vars}-{virtual_poly.expression.degree()}"):
            state = ProverState(spec, num_vars, sum_, virtual_poly)
            prover = self.prover_cls(state)
            aux = self.message_cls.auxiliary(state.degree, spec)
            challenges = []
            for round_ in range(num_vars):
                msg = prover.prove_round(state)
                msg.write(transcript)
                challenge = transcript.squeeze_challenge()
                challenges.append(challenge)
                state.next_round(msg.evaluate(aux, challenge), challenge)
        return challenges, state.into_evals()

    def verify(
        self,
        spec: FieldSpec,
        num_vars: int,
        degree: int,
        sum_: Fp,
        transcript: Keccak256Transcript,
    ) -> Tuple[Fp, List[Fp]]:
        msgs, challenges = [], []
        for _ in range(num_vars):
            msgs.append(self.message_cls.read(degree, transcript))
            challenges.append(transcript.squeeze_challenge())
        aux = self.message_cls.auxiliary(degree, spec)
        current = sum_
        for round_, (msg, challenge) in enumerate(zip(msgs, challenges)):
            if current != msg.sum():
                raise ValueError(
                    f"sum-check consistency failure at round {round_}"
                )
            current = msg.evaluate(aux, challenge)
        return current, challenges
