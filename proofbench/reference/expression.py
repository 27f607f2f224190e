# Frozen copy of plonkish_tpu_torch/utils/expression.py (itself from the reference's expression.rs) for the benchmark's plain reference.
"""Constraint expression IR.

Mirrors the reference AST (plonkish_backend/src/util/expression.rs:60-78):
Constant / CommonPolynomial(Identity, Lagrange(i), EqXY(idx)) /
Polynomial(Query{poly, rotation}) / Challenge(idx) / Negated / Sum / Product /
Scaled / DistributePowers — plus the generic `evaluate` catamorphism, degree,
used_* queries, and challenge-substituting simplification.

On TPU the AST is *not* interpreted row-by-row: `plonkish_tpu.piop` feeds it
to a memoized vectorized evaluator whose leaves are whole hypercube-sized limb
tensors, so one AST walk emits one fused XLA program evaluating the constraint
at every row at once (the reference's ExpressionRegistry tape —
expression/evaluator.rs — exists only to recover this very vectorization on a
scalar CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

# ---------------------------------------------------------------------------
# Core node types
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rotation:
    value: int = 0

    @staticmethod
    def cur() -> "Rotation":
        return Rotation(0)

    @staticmethod
    def prev() -> "Rotation":
        return Rotation(-1)

    @staticmethod
    def next() -> "Rotation":
        return Rotation(1)

    @property
    def distance(self) -> int:
        return abs(self.value)

    def __lt__(self, other):
        return self.value < other.value

    def __le__(self, other):
        return self.value <= other.value


@dataclasses.dataclass(frozen=True)
class Query:
    poly: int
    rotation: Rotation = Rotation(0)

    def __lt__(self, other):
        return (self.poly, self.rotation.value) < (other.poly, other.rotation.value)


# CommonPolynomial variants
@dataclasses.dataclass(frozen=True)
class Identity:
    pass


@dataclasses.dataclass(frozen=True)
class Lagrange:
    i: int


@dataclasses.dataclass(frozen=True)
class EqXY:
    idx: int


class Expression:
    """Base class; subclasses are immutable and structurally hashable."""

    __slots__ = ()

    # -- construction sugar ------------------------------------------------
    def __add__(self, other):
        return Sum(self, _as_expr(other))

    def __radd__(self, other):
        return Sum(_as_expr(other), self)

    def __sub__(self, other):
        return Sum(self, Negated(_as_expr(other)))

    def __rsub__(self, other):
        return Sum(_as_expr(other), Negated(self))

    def __mul__(self, other):
        if isinstance(other, Expression):
            return Product(self, other)
        return Scaled(self, other)  # field scalar

    def __rmul__(self, other):
        if isinstance(other, Expression):
            return Product(other, self)
        return Scaled(self, other)

    def __neg__(self):
        return Negated(self)

    # -- catamorphism ------------------------------------------------------
    def evaluate(
        self,
        constant: Callable[[Any], Any],
        common_poly: Callable[[Any], Any],
        poly: Callable[[Query], Any],
        challenge: Callable[[int], Any],
        negated: Callable[[Any], Any],
        sum_: Callable[[Any, Any], Any],
        product: Callable[[Any, Any], Any],
        scaled: Callable[[Any, Any], Any],
        _memo: dict | None = None,
    ):
        """Generic fold matching expression.rs:108-169; memoized on node
        identity so shared subtrees evaluate once (CSE for free)."""
        memo = {} if _memo is None else _memo
        ops = (constant, common_poly, poly, challenge, negated, sum_, product, scaled)
        return _eval(self, ops, memo)

    # -- analyses ----------------------------------------------------------
    def degree(self) -> int:
        return self.evaluate(
            lambda _: 0,
            lambda _: 1,
            lambda _: 1,
            lambda _: 0,
            lambda a: a,
            max,
            lambda a, b: a + b,
            lambda a, _: a,
        )

    def _used(self, f) -> set:
        out = self.evaluate(
            lambda _: None,
            lambda cp: f("common", cp),
            lambda q: f("poly", q),
            lambda c: f("challenge", c),
            lambda a: a,
            _merge_sets,
            _merge_sets,
            lambda a, _: a,
        )
        return out or set()

    def used_lagrange(self) -> set:
        return self._used(
            lambda kind, v: {v.i} if kind == "common" and isinstance(v, Lagrange) else None
        )

    def used_query(self) -> set:
        return self._used(lambda kind, v: {v} if kind == "poly" else None)

    def used_poly(self) -> set:
        return self._used(lambda kind, v: {v.poly} if kind == "poly" else None)

    def used_rotation(self) -> set:
        return self._used(lambda kind, v: {v.rotation} if kind == "poly" else None)

    def max_used_rotation_distance(self) -> int:
        rotations = self.used_rotation()
        return max((r.distance for r in rotations), default=0)

    def used_challenge(self) -> set:
        return self._used(lambda kind, v: {v} if kind == "challenge" else None)

    def simplified(self, challenges: list | None = None) -> "Expression":
        """Constant-fold, optionally substituting challenge values (Fp).

        Produces an expression with identical evaluation semantics
        (expression.rs:326-485); the exact AST shape is irrelevant for the
        vectorized evaluator, only values matter.
        """

        def fold_one(node, memo):
            if isinstance(node, Constant):
                return node
            if isinstance(node, Challenge):
                if challenges is not None:
                    return Constant(challenges[node.idx])
                return node
            if isinstance(node, (CommonPoly, Polynomial)):
                return node
            if isinstance(node, Negated):
                a = memo[id(node.a)]
                if isinstance(a, Constant):
                    return Constant(-a.value)
                return Negated(a)
            if isinstance(node, Sum):
                a, b = memo[id(node.a)], memo[id(node.b)]
                if isinstance(a, Constant) and isinstance(b, Constant):
                    return Constant(a.value + b.value)
                if isinstance(a, Constant) and a.value.is_zero():
                    return b
                if isinstance(b, Constant) and b.value.is_zero():
                    return a
                return Sum(a, b)
            if isinstance(node, Product):
                a, b = memo[id(node.a)], memo[id(node.b)]
                if isinstance(a, Constant) and isinstance(b, Constant):
                    return Constant(a.value * b.value)
                for x, y in ((a, b), (b, a)):
                    if isinstance(x, Constant):
                        if x.value.is_zero():
                            return Constant(x.value)
                        if x.value == 1:
                            return y
                return Product(a, b)
            if isinstance(node, Scaled):
                a = memo[id(node.a)]
                if isinstance(a, Constant):
                    return Constant(a.value * node.scalar)
                if node.scalar.is_zero():
                    return Constant(node.scalar)
                if node.scalar == 1:
                    return a
                return Scaled(a, node.scalar)
            if isinstance(node, DistributePowers):
                exprs = [memo[id(e)] for e in node.exprs]
                if len(exprs) == 1:
                    return exprs[0]
                return DistributePowers(tuple(exprs), memo[id(node.base)])
            raise TypeError(node)

        # iterative post-order with sharing (deep ASTs overflow recursion)
        memo: dict = {}
        stack = [(self, False)]
        while stack:
            node, ready = stack.pop()
            if id(node) in memo:
                continue
            kids = _children(node)
            if kids and not ready:
                stack.append((node, True))
                for k in kids:
                    if id(k) not in memo:
                        stack.append((k, False))
                continue
            memo[id(node)] = fold_one(node, memo)
        return memo[id(self)]


def _merge_sets(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _as_expr(v):
    if isinstance(v, Expression):
        return v
    return Constant(v)


@dataclasses.dataclass(frozen=True)
class Constant(Expression):
    value: Any  # host Fp


@dataclasses.dataclass(frozen=True)
class CommonPoly(Expression):
    poly: Any  # Identity | Lagrange | EqXY


@dataclasses.dataclass(frozen=True)
class Polynomial(Expression):
    query: Query


@dataclasses.dataclass(frozen=True)
class Challenge(Expression):
    idx: int


@dataclasses.dataclass(frozen=True)
class Negated(Expression):
    a: Expression


@dataclasses.dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression


@dataclasses.dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression


@dataclasses.dataclass(frozen=True)
class Scaled(Expression):
    a: Expression
    scalar: Any  # host Fp


@dataclasses.dataclass(frozen=True)
class DistributePowers(Expression):
    exprs: Tuple[Expression, ...]
    base: Expression


def _children(node):
    if isinstance(node, (Negated, Scaled)):
        return (node.a,)
    if isinstance(node, (Sum, Product)):
        return (node.a, node.b)
    if isinstance(node, DistributePowers):
        return (*node.exprs, node.base)
    return ()


def _eval(root, ops, memo):
    """Iterative post-order fold (deep circuit ASTs — e.g. 32-bit word sums
    chained across SHA-256 gates — exceed Python's recursion limit)."""
    constant, common_poly, poly, challenge, negated, sum_, product, scaled = ops
    stack = [(root, False)]
    while stack:
        node, ready = stack.pop()
        key = id(node)
        if key in memo:
            continue
        if not ready:
            kids = _children(node)
            if kids:
                stack.append((node, True))
                # reversed so children POP left-to-right: a left-leaning sum
                # chain then folds as (t1 t2 + t3 + ...), keeping only O(1)
                # intermediate values live — the tape register allocator
                # (piop/tape.py) depends on this for bounded register count
                for k in reversed(kids):
                    if id(k) not in memo:
                        stack.append((k, False))
                continue
        if isinstance(node, Constant):
            out = constant(node.value)
        elif isinstance(node, CommonPoly):
            out = common_poly(node.poly)
        elif isinstance(node, Polynomial):
            out = poly(node.query)
        elif isinstance(node, Challenge):
            out = challenge(node.idx)
        elif isinstance(node, Negated):
            out = negated(memo[id(node.a)])
        elif isinstance(node, Sum):
            out = sum_(memo[id(node.a)], memo[id(node.b)])
        elif isinstance(node, Product):
            out = product(memo[id(node.a)], memo[id(node.b)])
        elif isinstance(node, Scaled):
            out = scaled(memo[id(node.a)], node.scalar)
        elif isinstance(node, DistributePowers):
            # expression.rs:155-167: e_0 + Σ_{i>=1} base^i * e_i
            assert node.exprs
            if len(node.exprs) == 1:
                out = memo[id(node.exprs[0])]
            else:
                scalar = memo[id(node.base)]
                acc = memo[id(node.exprs[0])]
                power = scalar
                for i, expr in enumerate(node.exprs[1:]):
                    if i > 0:
                        power = product(power, scalar)
                    acc = sum_(acc, product(power, memo[id(expr)]))
                out = acc
        else:
            raise TypeError(node)
        memo[key] = out
    return memo[id(root)]


# -- helper constructors matching the reference API -------------------------

def identity() -> Expression:
    return CommonPoly(Identity())


def lagrange(i: int) -> Expression:
    return CommonPoly(Lagrange(i))


def eq_xy(idx: int) -> Expression:
    return CommonPoly(EqXY(idx))


def distribute_powers(exprs, base: Expression) -> Expression:
    exprs = list(exprs)
    assert exprs
    if len(exprs) == 1:
        return exprs[0]
    return DistributePowers(tuple(exprs), base)
