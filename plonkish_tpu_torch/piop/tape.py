# Copied from plonkish_tpu/piop/tape.py (the host compiler; the XLA
# interpreter is replaced by the round kernel of kernels/sumcheck.py).
"""SSA tape compiler for constraint expressions.

An expression is compiled once into a register-allocated instruction tape
``(op, a, b, dst)``: the round kernel K3 interprets it per hypercube pair, so
one build of the kernel serves every expression, and the plain version runs
the same tape over whole tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..fields import limb
from ..fields.spec import FieldSpec
from ..utils.expression import EqXY, Identity, Lagrange

OP_ADD = 0
OP_MUL = 1
OP_NEG = 2
OP_CONST = 3  # a = constant-table row
OP_LOAD = 4  # a = leaf-table row


@dataclasses.dataclass(frozen=True, eq=False)  # id-hash: usable as a jit
class Tape:  # static argument (tapes are cached one per expression)
    leaf_keys: Tuple  # row order of the stacked leaves tensor
    consts: Tuple[int, ...]  # canonical ints, one Montgomery row each
    instrs: np.ndarray  # [n, 4] int32: (op, a, b, dst-register)
    num_regs: int
    out_reg: int

    def const_rows(self, spec: FieldSpec, device) -> torch.Tensor:
        """Montgomery constants as int32[max(1, n), 8]."""
        return limb.from_canonical_ints(spec, list(self.consts) or [0], device)

    def remapped(self, table_keys: Sequence[Tuple]) -> np.ndarray:
        """``instrs`` with each leaf operand replaced by its row of a stacked
        state whose rows are ``table_keys``; row ``len(table_keys)``, one past
        the tables, is the identity leaf.  K3 reads its leaves by these rows."""
        row_of = {k: i for i, k in enumerate(table_keys)}
        row_of[("identity",)] = len(table_keys)
        instrs = self.instrs.copy()
        is_load = instrs[:, 0] == OP_LOAD
        instrs[is_load, 1] = np.asarray(
            [row_of[k] for k in self.leaf_keys], dtype=np.int32
        )[instrs[is_load, 1]]
        return instrs


def compile_tape(expr, spec: FieldSpec, challenges: Sequence = None) -> Tape:
    """Expression -> register-allocated SSA tape.

    CSE happens twice: the catamorphism memoizes shared subtrees by node
    identity, and instruction emission hash-conses on (op, a, b) so
    structurally repeated subterms collapse (evaluator.rs:141-151 does the
    same for its Calculation list).
    """
    instrs: List[Tuple[int, int, int]] = []  # (op, a, b) over value ids
    cse: Dict[Tuple[int, int, int], int] = {}
    leaf_ids: Dict[Tuple, int] = {}
    leaf_keys: List[Tuple] = []
    const_ids: Dict[int, int] = {}
    consts: List[int] = []

    def emit(op: int, a: int, b: int = 0) -> int:
        key = (op, a, b)
        if key in cse:
            return cse[key]
        instrs.append(key)
        vid = len(instrs) - 1
        cse[key] = vid
        return vid

    def leaf(key: Tuple) -> int:
        if key not in leaf_ids:
            leaf_keys.append(key)
            leaf_ids[key] = len(leaf_keys) - 1
        return emit(OP_LOAD, leaf_ids[key])

    def const(c: int) -> int:
        c = int(c) % spec.p
        if c not in const_ids:
            consts.append(c)
            const_ids[c] = len(consts) - 1
        return emit(OP_CONST, const_ids[c])

    def common(cp):
        if isinstance(cp, Identity):
            return leaf(("identity",))
        if isinstance(cp, Lagrange):
            return leaf(("lagrange", cp.i))
        if isinstance(cp, EqXY):
            return leaf(("eq_xy", cp.idx))
        raise TypeError(cp)

    out_vid = expr.evaluate(
        const,
        common,
        lambda q: leaf(("poly", q.poly, q.rotation.value)),
        (lambda idx: const(int(challenges[idx])))
        if challenges is not None
        else lambda idx: (_ for _ in ()).throw(
            AssertionError("challenges must be substituted before compile")
        ),
        lambda a: emit(OP_NEG, a),
        lambda a, b: emit(OP_ADD, *sorted((a, b))),
        lambda a, b: emit(OP_MUL, *sorted((a, b))),
        lambda a, s: emit(OP_MUL, *sorted((a, const(int(s))))),
    )

    # --- linear-scan register allocation (dst may alias a dying operand:
    # the scan body reads both operands before writing) ---
    n = len(instrs)
    last_use = [vid for vid in range(n)]  # a value with no later use dies at
    for vid, (op, a, b) in enumerate(instrs):  # its own instruction
        if op in (OP_ADD, OP_MUL):
            last_use[a] = max(last_use[a], vid)
            last_use[b] = max(last_use[b], vid)
        elif op == OP_NEG:
            last_use[a] = max(last_use[a], vid)
    last_use[out_vid] = n  # keep the result live

    free: List[int] = []
    num_regs = 0
    reg_of: List[int] = [0] * n
    expiring: Dict[int, List[int]] = {}
    for vid in range(n):
        expiring.setdefault(last_use[vid], []).append(vid)
    coded = np.zeros((n, 4), np.int32)
    for vid, (op, a, b) in enumerate(instrs):
        ra = reg_of[a] if op in (OP_ADD, OP_MUL, OP_NEG) else a
        rb = reg_of[b] if op in (OP_ADD, OP_MUL) else b
        # free operands dying here BEFORE allocating dst so dst can reuse
        for dead in expiring.get(vid, ()):  # includes vid itself if unused
            if dead < vid:
                free.append(reg_of[dead])
        if free:
            dst = free.pop()
        else:
            dst = num_regs
            num_regs += 1
        reg_of[vid] = dst
        coded[vid] = (op, ra, rb, dst)

    return Tape(
        leaf_keys=tuple(leaf_keys),
        consts=tuple(consts),
        instrs=coded,
        num_regs=max(num_regs, 1),
        out_reg=reg_of[out_vid],
    )
