# Copied from plonkish_tpu/utils/relaxed.py; imports resolve inside plonkish_tpu_torch.
"""Relaxed/folding expression machinery for Protostar.

Port of plonkish_backend/src/util/expression/relaxed.rs:
`products()` factors a constraint into Σ scalar·(preprocess part)·Π(foldees);
`cross_term_expressions()` expands the degree-d fold (acc + r·incoming)
binomially into d-1 cross-term expressions over [preprocess, acc polys,
incoming polys] with challenge offsets; `relaxed_expression()` homogenizes
with powers of u.  Pure preprocessing-time symbolic algebra.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from ..fields.host import Fp
from . import expression as ex
from .expression import (
    Challenge,
    CommonPoly,
    Constant,
    EqXY,
    Expression,
    Identity,
    Lagrange,
    Polynomial,
    Query,
    Rotation,
)


@dataclasses.dataclass
class PolynomialSet:
    preprocess: Set[int]
    folding: Set[int]


@dataclasses.dataclass
class Product:
    preprocess: Expression  # constants/common polys/preprocess queries only
    foldees: List[Expression]  # Polynomial or Challenge leaves

    @property
    def folding_degree(self) -> int:
        return len(self.foldees)

    def expression(self) -> Expression:
        acc = self.preprocess
        for f in self.foldees:
            acc = acc * f
        return acc


def products(spec, preprocess_polys: Set[int], constraint: Expression) -> List[Product]:
    """relaxed.rs:150-241."""

    def constant(c):
        return [Product(Constant(c), [])]

    def common(cp):
        return [Product(CommonPoly(cp), [])]

    def poly(q):
        if q.poly in preprocess_polys:
            return [Product(Polynomial(q), [])]
        return [Product(Constant(Fp.one(spec)), [Polynomial(q)])]

    def challenge(idx):
        return [Product(Constant(Fp.one(spec)), [Challenge(idx)])]

    def negated(ps):
        return [Product(Negify(p.preprocess), list(p.foldees)) for p in ps]

    def Negify(e):
        return ex.Negated(e)

    def sum_(lhs, rhs):
        return lhs + rhs

    def product(lhs, rhs):
        out = []
        for l in lhs:
            for r in rhs:
                out.append(
                    Product(l.preprocess * r.preprocess, l.foldees + r.foldees)
                )
        return out

    def scaled(ps, s):
        return [Product(p.preprocess * Constant(s), list(p.foldees)) for p in ps]

    prods = constraint.evaluate(
        constant, common, poly, challenge, negated, sum_, product, scaled
    )

    # normalize each preprocess part into scalar * (common/query product)
    out = []
    for p in prods:
        scalar, pre = _split_preprocess(spec, p.preprocess)
        if pre is None:
            p.preprocess = Constant(scalar)
        elif scalar == 1:
            p.preprocess = pre
        else:
            p.preprocess = pre * scalar
        out.append(p)
    return out


def _split_preprocess(spec, expr: Expression) -> Tuple[Fp, Expression | None]:
    """relaxed.rs:211-227: factor a preprocess-only product into
    (scalar, common-part or None)."""

    def constant(c):
        return (c, None)

    def common(cp):
        return (Fp.one(spec), CommonPoly(cp))

    def poly(q):
        return (Fp.one(spec), Polynomial(q))

    def challenge(idx):
        raise AssertionError("challenge in preprocess part")

    def negated(v):
        s, pre = v
        return (-s, pre)

    def product(lhs, rhs):
        (ls, lp), (rs, rp) = lhs, rhs
        if lp is not None and rp is not None:
            pre = lp * rp
        else:
            pre = lp if lp is not None else rp
        return (ls * rs, pre)

    def scaled(v, s):
        return (v[0] * s, v[1])

    def sum_(lhs, rhs):
        raise AssertionError("sum in preprocess part")

    return expr.evaluate(
        constant, common, poly, challenge, negated, sum_, product, scaled
    )


def folding_degree(products_: Sequence[Product]) -> int:
    return max((p.folding_degree for p in products_), default=0)


def _poly_key(node) -> tuple:
    """Canonical sort key for grouping cross-term monomials."""
    if isinstance(node, CommonPoly):
        cp = node.poly
        if isinstance(cp, Identity):
            return (0, 0, 0, 0)
        if isinstance(cp, Lagrange):
            return (0, 1, cp.i, 0)
        return (0, 2, cp.idx, 0)
    assert isinstance(node, Polynomial)
    return (1, 0, node.query.poly, node.query.rotation.value)


def cross_term_expressions(
    spec,
    poly_set: PolynomialSet,
    products_: Sequence[Product],
    num_challenges: int,
) -> List[Expression]:
    """relaxed.rs:34-130.

    Returns folding_degree-1 expressions over the combined poly list
    [preprocess (re-indexed 0..), acc folding polys, incoming folding polys]
    and challenges [acc challenges, acc u, incoming challenges, incoming u].
    """
    fd = folding_degree(products_)
    num_ts = max(fd - 1, 0)
    u = num_challenges
    pre_idx = {p: i for i, p in enumerate(sorted(poly_set.preprocess))}
    fold_idx = {p: i for i, p in enumerate(sorted(poly_set.folding))}

    scalars: List[Dict[tuple, Expression]] = [dict() for _ in range(num_ts)]
    keyed_polys: List[Dict[tuple, list]] = [dict() for _ in range(num_ts)]

    for product in products_:
        common_scalar, common_polys = _preprocess_to_monomial(
            spec, product.preprocess, pre_idx
        )
        pads = fd - product.folding_degree
        slots = [None] * pads + list(product.foldees)
        for idx in range(1, (1 << fd) - 1):
            scalar: Expression = Constant(common_scalar)
            polys = list(common_polys)
            for nth, foldee in enumerate(slots):
                if (idx >> nth) & 1:
                    poly_offset = len(pre_idx) + len(fold_idx)
                    challenge_offset = num_challenges + 1
                else:
                    poly_offset = len(pre_idx)
                    challenge_offset = 0
                if foldee is None:
                    scalar = scalar * Challenge(challenge_offset + u)
                elif isinstance(foldee, Challenge):
                    scalar = scalar * Challenge(challenge_offset + foldee.idx)
                elif isinstance(foldee, Polynomial):
                    poly = poly_offset + fold_idx[foldee.query.poly]
                    polys.append(
                        Polynomial(Query(poly, foldee.query.rotation))
                    )
                else:
                    raise AssertionError(foldee)
            key = tuple(sorted(_poly_key(p) for p in polys))
            bucket = bin(idx).count("1") - 1
            if key in scalars[bucket]:
                scalars[bucket][key] = scalars[bucket][key] + scalar
            else:
                scalars[bucket][key] = scalar
                keyed_polys[bucket][key] = sorted(polys, key=_poly_key)

    out = []
    for bucket_scalars, bucket_polys in zip(scalars, keyed_polys):
        acc = None
        for key, scalar in bucket_scalars.items():
            term = None
            for p in bucket_polys[key]:
                term = p if term is None else term * p
            term = scalar if term is None else term * scalar
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else Constant(Fp.zero(spec)))
    return out


def _preprocess_to_monomial(spec, expr: Expression, pre_idx) -> Tuple[Fp, list]:
    """relaxed.rs:50-70: evaluate the preprocess part into
    (scalar, [common/query leaves re-indexed])."""

    def constant(c):
        return (c, [])

    def common(cp):
        return (Fp.one(spec), [CommonPoly(cp)])

    def poly(q):
        return (
            Fp.one(spec),
            [Polynomial(Query(pre_idx[q.poly], q.rotation))],
        )

    def challenge(idx):
        raise AssertionError

    def negated(v):
        return (-v[0], v[1])

    def sum_(lhs, rhs):
        raise AssertionError

    def product(lhs, rhs):
        return (lhs[0] * rhs[0], lhs[1] + rhs[1])

    def scaled(v, s):
        return (v[0] * s, v[1])

    return expr.evaluate(
        constant, common, poly, challenge, negated, sum_, product, scaled
    )


def relaxed_expression(
    spec, products_: Sequence[Product], u: int
) -> Expression:
    """relaxed.rs:132-148: homogenize with powers of Challenge(u)."""
    fd = folding_degree(products_)
    acc = None
    for product in products_:
        power = fd - product.folding_degree
        term = product.expression()
        for _ in range(power):
            term = term * Challenge(u)
        acc = term if acc is None else acc + term
    return acc if acc is not None else Constant(Fp.zero(spec))
