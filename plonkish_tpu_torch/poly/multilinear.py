"""Dense multilinear polynomials over the boolean hypercube, as torch tensors
(port of plonkish_tpu/poly/multilinear.py).

The evaluation vector is a Montgomery ``int32[2^k, 8]`` tensor on the
polynomial's device.  Index bit 0 is the first variable, so ``fix_var``
consumes neighbouring pairs (2i, 2i+1), as in the reference.  The rotation
patterns and the verifier's recombination below are host integer work,
copied from the reference.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..fields import limb
from ..fields.host import Fp
from ..fields.spec import FieldSpec
from ..utils.bh import BooleanHypercube
from ..utils.expression import Rotation


class MLPoly:
    """A multilinear polynomial in evaluation form (Montgomery limbs)."""

    __slots__ = ("spec", "evals")

    def __init__(self, spec: FieldSpec, evals: torch.Tensor):
        assert evals.dim() == 2 and evals.shape[1] == limb.L, evals.shape
        self.spec = spec
        self.evals = evals

    @property
    def num_vars(self) -> int:
        return (self.evals.shape[0]).bit_length() - 1

    @property
    def device(self):
        return self.evals.device

    def __len__(self):
        return self.evals.shape[0]

    # ---- constructors ----
    @classmethod
    def zero(cls, spec: FieldSpec, num_vars: int, device) -> "MLPoly":
        return cls(spec, limb.zeros((1 << num_vars,), device))

    @classmethod
    def from_fps(cls, spec: FieldSpec, values: Sequence[Fp], device) -> "MLPoly":
        return cls(spec, limb.from_canonical_ints(spec, [v.v for v in values], device))

    @classmethod
    def from_ints(cls, spec: FieldSpec, values: Sequence[int], device) -> "MLPoly":
        return cls(spec, limb.from_canonical_ints(spec, values, device))

    def to_fps(self) -> List[Fp]:
        return [Fp(v, self.spec) for v in limb.to_canonical_ints(self.spec, self.evals)]

    # ---- arithmetic ----
    def __add__(self, other: "MLPoly") -> "MLPoly":
        return MLPoly(self.spec, limb.add(self.spec, self.evals, other.evals))

    def __sub__(self, other: "MLPoly") -> "MLPoly":
        return MLPoly(self.spec, limb.sub(self.spec, self.evals, other.evals))

    def scale(self, scalar: Fp) -> "MLPoly":
        c = limb.const(self.spec, int(scalar), self.device)
        return MLPoly(self.spec, limb.mont_mul(self.spec, self.evals, c))

    # ---- core ops ----
    def fix_var(self, x: Fp) -> "MLPoly":
        c = limb.const(self.spec, int(x), self.device)
        return MLPoly(self.spec, limb.fold_pairs(self.spec, self.evals, c))

    def fix_last_vars(self, xs: Sequence[Fp]) -> "MLPoly":
        """Fix the highest-index variables (multilinear.rs:158-177)."""
        evals = self.evals
        for x in reversed(list(xs)):
            c = limb.const(self.spec, int(x), self.device)
            half = evals.shape[0] // 2
            evals = limb.fold_halves(self.spec, evals[:half], evals[half:], c)
        return MLPoly(self.spec, evals)

    def evaluate(self, point: Sequence[Fp]) -> Fp:
        assert len(point) == self.num_vars
        evals = self.evals
        for x in point:
            c = limb.const(self.spec, int(x), self.device)
            evals = limb.fold_pairs(self.spec, evals, c)
        return Fp(limb.to_canonical_ints(self.spec, evals)[0], self.spec)

    def evaluate_for_rotation(self, point: Sequence[Fp], rotation: Rotation) -> List[Fp]:
        """Partial evals recombinable by `rotation_eval` into the evaluation
        of the rotated polynomial (multilinear.rs:191-263)."""
        spec = self.spec
        num_vars = self.num_vars
        if rotation.value == 0:
            return [self.evaluate(point)]
        distance = rotation.distance
        num_x = num_vars - distance
        x = [Fp(int(p), spec) for p in point]

        def cst(v):
            return limb.const(spec, int(v), self.device)

        out = []
        if rotation.value < 0:
            xs = x[distance:]
            pattern = rotation_eval_point_pattern(num_vars, distance, next_=False)
            offset_mask = (1 << num_vars) - (1 << num_x)
            for pat in pattern:
                offset = pat & offset_mask
                evals = self.evals[offset: offset + (1 << num_x)]
                for idx, x_i in enumerate(xs):
                    xv = 1 - x_i if (pat >> idx) & 1 else x_i
                    evals = limb.fold_pairs(spec, evals, cst(xv))
                out.append(evals)
        else:
            xs = x[:num_x]
            pattern = rotation_eval_point_pattern(num_vars, distance, next_=True)
            skip_mask = (1 << distance) - 1
            step = 1 << (distance + 1)
            for pat in pattern:
                skip = pat & skip_mask
                x_0 = 1 - xs[0] if (pat >> distance) & 1 else xs[0]
                grid = self.evals.reshape(-1, step, limb.L)
                evals = limb.fold_halves(
                    spec, grid[:, skip], grid[:, skip + step // 2], cst(x_0)
                )
                for i in range(1, num_x):
                    x_i = xs[i]
                    xv = 1 - x_i if (pat >> (distance + i)) & 1 else x_i
                    evals = limb.fold_pairs(spec, evals, cst(xv))
                out.append(evals)
        vals = limb.to_canonical_ints(spec, torch.cat(out, dim=0))
        return [Fp(v, spec) for v in vals]


def eq_xy_evals(spec: FieldSpec, y: Sequence[Fp], device) -> torch.Tensor:
    """eq(x, y) table by doubling expansion (multilinear.rs:91-127) ->
    Montgomery [2^len(y), 8]."""
    c = limb._consts(spec, device)
    d = c["one"].clone()
    for y_i in reversed(list(y)):
        hi = limb.d_mul(d, limb.d_const(spec, int(y_i), device), c)
        lo = limb.d_sub(d, hi, c)
        d = torch.stack([lo, hi], dim=2).reshape(limb.D, -1)
    return limb.pack(d)


def eq_xy(spec: FieldSpec, y: Sequence[Fp], device) -> MLPoly:
    return MLPoly(spec, eq_xy_evals(spec, y, device))


# ---------------------------------------------------------------------------
# Rotation patterns & verifier-side recombination (host, exact ints / Fp)
# ---------------------------------------------------------------------------

def rotation_eval_point_pattern(num_vars: int, distance: int, next_: bool) -> List[int]:
    """multilinear.rs:526-545."""
    bh = BooleanHypercube(num_vars)
    remainder = bh.primitive if next_ else bh.x_inv
    pattern = [0] * (1 << distance)
    for depth in range(distance):
        step = 1 << (distance - depth)
        half = step >> 1
        for start in range(0, len(pattern), step):
            for off in range(half):
                e = start + off
                o = start + off + half
                rotated = pattern[e] << 1 if next_ else pattern[e] >> 1
                pattern[o] = rotated ^ remainder
                pattern[e] = rotated
    return pattern


def rotation_eval_coeff_pattern(num_vars: int, distance: int, next_: bool) -> List[int]:
    """multilinear.rs:547-570."""
    bh = BooleanHypercube(num_vars)
    remainder = (bh.primitive - (1 << num_vars)) if next_ else (bh.x_inv << distance)
    pattern = [0] * (1 << (distance - 1))
    for depth in range(distance - 1):
        step = 1 << (distance - depth - 1)
        half = step >> 1
        for start in range(0, len(pattern), step):
            for off in range(half):
                e = start + off
                o = start + off + half
                rotated = pattern[e] << 1 if next_ else pattern[e] >> 1
                pattern[o] = rotated ^ remainder
                pattern[e] = rotated
    return pattern


def rotation_eval(x: Sequence[Fp], rotation: Rotation, evals_for_rotation: Sequence[Fp]) -> Fp:
    """Recombine 2^distance partial evals into the rotated poly's evaluation
    (multilinear.rs:433-476).  Host-side: O(2^distance) field ops."""
    if rotation.value == 0:
        assert len(evals_for_rotation) == 1
        return evals_for_rotation[0]
    num_vars = len(x)
    distance = rotation.distance
    assert len(evals_for_rotation) == 1 << distance
    assert distance <= num_vars

    if rotation.value < 0:
        pattern = rotation_eval_coeff_pattern(num_vars, distance, next_=False)
        nths = list(range(distance, 0, -1))
        xs = list(reversed(x[0:distance]))
    else:
        pattern = rotation_eval_coeff_pattern(num_vars, distance, next_=True)
        nths = list(range(num_vars - 1, num_vars - 1 + distance))
        xs = list(x[num_vars - distance:])

    evals = list(evals_for_rotation)
    for idx, (x_i, nth) in enumerate(zip(xs, nths)):
        pat_bits = [
            (pattern[p] >> nth) & 1 for p in range(0, len(pattern), 1 << idx)
        ]
        next_evals = []
        for bit, (e0, e1) in zip(pat_bits, zip(evals[0::2], evals[1::2])):
            if bit:
                next_evals.append((e0 - e1) * x_i + e1)
            else:
                next_evals.append((e1 - e0) * x_i + e0)
        evals = next_evals
    return evals[0]


def rotation_eval_points(x: Sequence[Fp], rotation: Rotation) -> List[List[Fp]]:
    """The 2^distance points at which the prover opens a rotated query
    (multilinear.rs:478-524)."""
    if rotation.value == 0:
        return [list(x)]
    spec = x[0].spec
    one_ = Fp.one(spec)
    zero = Fp.zero(spec)
    distance = rotation.distance
    num_x = len(x) - distance
    points = []
    if rotation.value < 0:
        pattern = rotation_eval_point_pattern(len(x), distance, next_=False)
        xs = x[distance:]
        for pat in pattern:
            pt = [
                (one_ - xs[idx]) if (pat >> idx) & 1 else xs[idx]
                for idx in range(num_x)
            ]
            pt += [
                one_ if (pat >> (idx + num_x)) & 1 else zero
                for idx in range(distance)
            ]
            points.append(pt)
    else:
        pattern = rotation_eval_point_pattern(len(x), distance, next_=True)
        xs = x[:num_x]
        for pat in pattern:
            pt = [one_ if (pat >> idx) & 1 else zero for idx in range(distance)]
            pt += [
                (one_ - xs[idx]) if (pat >> (idx + distance)) & 1 else xs[idx]
                for idx in range(num_x)
            ]
            points.append(pt)
    return points
