"""Constraint evaluation over the whole boolean hypercube (port of
plonkish_tpu/piop/evaluator.py).

One memoised walk of the expression over whole-hypercube digit tensors:
rotations become BH gathers, Identity a Montgomery iota, Lagrange(i) a
one-hot.  A node's digits are dropped after its last parent has read them,
so only the walk's frontier is live (each value is int64 [16, 2^k], 128 MiB
at k = 20).  Used for the lookup compression of the HyperPlonk prover and
for Protostar's cross terms.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..fields import limb
from ..fields.host import Fp
from ..fields.spec import FieldSpec
from ..utils.bh import BooleanHypercube
from ..utils.expression import Expression, Identity, Lagrange, _children


class _ReleasingMemo(dict):
    """The walk's memo, deleting a node's value at its last read."""

    def __init__(self, reads):
        super().__init__()
        self.reads = reads  # id(node) -> reads left

    def __getitem__(self, key):
        value = super().__getitem__(key)
        self.reads[key] -= 1
        if self.reads[key] == 0:
            del self[key]
        return value


def _reads(root: Expression) -> dict:
    """id(node) -> how many times the walk reads its value: once for each
    occurrence among its parents' children, and once the root's."""
    reads = {id(root): 1}
    seen, stack = {id(root)}, [root]
    while stack:
        for kid in _children(stack.pop()):
            reads[id(kid)] = reads.get(id(kid), 0) + 1
            if id(kid) not in seen:
                seen.add(id(kid))
                stack.append(kid)
    return reads


def identity_digits(spec: FieldSpec, num_vars: int, device) -> torch.Tensor:
    """Montgomery digits [16, 2^k] of f(b) = b."""
    n = 1 << num_vars
    b = torch.arange(n, dtype=torch.int64, device=device)
    d = torch.zeros((limb.D, n), dtype=torch.int64, device=device)
    d[0], d[1] = b & 0xFFFF, b >> 16
    c = limb._consts(spec, device)
    return limb.d_mul(d, c["r2"], c)


def identity_table(spec: FieldSpec, num_vars: int, device) -> torch.Tensor:
    """Montgomery int32[2^k, 8] of f(b) = b."""
    return limb.pack(identity_digits(spec, num_vars, device))


def evaluate_on_hypercube(
    spec: FieldSpec,
    expression: Expression,
    num_vars: int,
    polys: Sequence[torch.Tensor],
    challenges: Sequence[Fp],
    device,
) -> torch.Tensor:
    """`expression` at every hypercube point -> Montgomery int32[2^k, 8]."""
    n = 1 << num_vars
    bh = BooleanHypercube(num_vars)
    c = limb._consts(spec, device)

    def cst(v):
        return limb.d_const(spec, int(v), device).expand(limb.D, n)

    def common(cp):
        if isinstance(cp, Identity):
            return identity_digits(spec, num_vars, device)
        if isinstance(cp, Lagrange):
            d = torch.zeros((limb.D, n), dtype=torch.int64, device=device)
            d[:, int(bh.iter_array[cp.i % n])] = c["one"][:, 0]
            return d
        raise TypeError(cp)

    def poly(q):
        tbl = polys[q.poly]
        if q.rotation.value != 0:
            rmap = torch.as_tensor(bh.rotation_map(q.rotation.value), device=device)
            tbl = tbl[rmap]
        return limb.unpack(tbl)

    out = expression.evaluate(
        cst,
        common,
        poly,
        lambda idx: cst(challenges[idx]),
        lambda a: limb.d_neg(a, c),
        lambda a, b: limb.d_add(a, b, c),
        lambda a, b: limb.d_mul(a, b, c),
        lambda a, s: limb.d_mul(a, limb.d_const(spec, int(s), device), c),
        _memo=_ReleasingMemo(_reads(expression)),
    )
    return limb.pack(out.expand(limb.D, n))
