"""Sum-check kernels K3 (round evaluations) and K4 (fold), with plain versions.

K3 replaces plonkish_tpu/pallas/sumcheck.py::_round_kernel
(pallas/sumcheck.py:159, launched by ``_round_evals_jit``) and K4 replaces
::_fold_kernel (pallas/sumcheck.py:225, launched by ``_fold_tables_jit``).
Both run over BN254 Fr and over BN254 Fq, the scalar field of Grumpkin that
HyperPlonk uses with IPA and Hyrax.  K4's CUDA source is ``csrc/sumcheck.cu``
over ``csrc/field.cuh``; K3's
kernel is generated for each expression tape by ``kernels/sumcheck_gen.py``
over ``csrc/sumcheck.cuh`` and built at its first use.

State layout: every live table of the prover stacked as Montgomery
``int32[T, 2s, 8]`` in natural hypercube order, so a fix_var pair is two
neighbouring rows (2i, 2i+1), as in the reference's host path
(sum_check.py:865-868).

K3 evaluates a compiled expression tape (piop/tape.py) at every pair for
t = 1..d, with every leaf at lo + t*(hi - lo), and returns the d sums as
Montgomery ``int32[d, 8]``.  Leaf operands of OP_LOAD index the stacked rows;
the operand T selects the identity polynomial, whose value at pair i is
``base + i * mul + (t - 1) * step`` (``id_params``, the rows of int32[3, 8]:
mul as raw digits of 2^(r+1) * R^2 mod p, base and step Montgomery).

K4 folds every table at once: new[i] = lo + c * (hi - lo).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import limb
from ..fields.spec import BN254_FR, FieldSpec
from ..piop import tape as tape_mod
from . import LAUNCHES, field_id
from . import build
from . import sumcheck_gen


def _check_state(stacked: torch.Tensor):
    if stacked.dtype != torch.int32 or stacked.dim() != 3 or stacked.shape[2] != 8:
        raise ValueError(f"state must be int32[T, 2s, 8], got {stacked.dtype} {tuple(stacked.shape)}")
    if stacked.shape[1] % 2:
        raise ValueError("state rows must pair up")
    if not stacked.is_contiguous():
        raise ValueError("state must be contiguous")


# ---------------------------------------------------------------------------
# K3: round evaluations
# ---------------------------------------------------------------------------

def sumcheck_round_plain(spec, stacked, instrs, consts, num_regs, out_reg,
                         degree, id_params):
    """The tape evaluated over whole tensors for t = 1..degree, then summed."""
    c = limb._consts(spec, stacked.device)
    t_count, rows, _ = stacked.shape
    s = rows // 2
    flat = limb.unpack(stacked).reshape(16, t_count, rows)
    lo, hi = flat[:, :, 0::2], flat[:, :, 1::2]
    cur = [hi[:, j] for j in range(t_count)]
    step = [limb.d_sub(hi[:, j], lo[:, j], c) for j in range(t_count)]
    id_mul, id_base, id_step = (limb.unpack(v) for v in id_params)
    i = torch.arange(s, dtype=torch.int64, device=stacked.device)
    i_digits = torch.zeros((16, s), dtype=torch.int64, device=stacked.device)
    i_digits[0], i_digits[1] = i & 0xFFFF, i >> 16
    ident = limb.d_add(limb.d_mul(i_digits, id_mul, c), id_base, c)
    cvals = limb.unpack(consts)
    out = []
    for t in range(1, degree + 1):
        if t > 1:
            cur = [limb.d_add(a, b, c) for a, b in zip(cur, step)]
            ident = limb.d_add(ident, id_step, c)
        regs = [None] * num_regs
        for op, a, b, dst in np.asarray(instrs).tolist():
            if op == tape_mod.OP_ADD:
                v = limb.d_add(regs[a], regs[b], c)
            elif op == tape_mod.OP_MUL:
                v = limb.d_mul(regs[a], regs[b], c)
            elif op == tape_mod.OP_NEG:
                v = limb.d_neg(regs[a], c)
            elif op == tape_mod.OP_CONST:
                v = cvals[:, a: a + 1].expand(16, s)
            else:
                v = ident if a == t_count else cur[a]
            regs[dst] = v
        out.append(limb.d_sum(regs[out_reg], c))
    return limb.pack(torch.cat(out, dim=1))


FOLD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def round_launch(kern, stream, stacked, consts, degree, id_params):
    """Launch K3 through `kern` (a generated kernel or its host twin)."""
    _check_state(stacked)
    if degree != kern.degree:
        raise ValueError(f"the kernel was generated for degree {kern.degree}, not {degree}")
    dev = stacked.device
    s = stacked.shape[1] // 2
    consts = consts.to(dev).contiguous()
    ids = id_params.to(dev).contiguous()
    # one wave of the card: a grid-stride loop gives every thread its share
    groups = -(-s // sumcheck_gen.WARP)
    shares = -(-degree // kern.warps)
    blocks = max(1, min(groups, kern.resident // shares))
    partial = torch.empty((blocks, degree, 8), dtype=torch.int32, device=dev)
    out = torch.empty((degree, 8), dtype=torch.int32, device=dev)
    rc = kern.fn(stacked.data_ptr(), s, consts.data_ptr(), ids.data_ptr(), blocks,
                 kern.warps, partial.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sumcheck_round launch failed: CUDA error {rc}")
    LAUNCHES["sumcheck_round"] += 1
    return out


def sumcheck_round_cuda(spec, stacked, instrs, consts, num_regs, out_reg,
                        degree, id_params):
    field_id(spec)
    if stacked.device.type != "cuda":
        raise ValueError("state must be a CUDA tensor")
    kern = sumcheck_gen.kernel(instrs, num_regs, out_reg, stacked.shape[0], degree, spec)
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    return round_launch(kern, stream, stacked, consts, degree, id_params)


def round_evals(spec, stacked, instrs, consts, num_regs, out_reg, degree,
                id_params):
    """K3: Montgomery sums int32[degree, 8] of the round polynomial at t = 1..d."""
    if stacked.device.type == "cpu":
        return sumcheck_round_plain(spec, stacked, instrs, consts, num_regs,
                                    out_reg, degree, id_params)
    return sumcheck_round_cuda(spec, stacked, instrs, consts, num_regs,
                               out_reg, degree, id_params)


# ---------------------------------------------------------------------------
# K4: fold
# ---------------------------------------------------------------------------

def fold_plain(spec, stacked, challenge):
    """[T, 2s, 8] -> [T, s, 8]: lo + c * (hi - lo) on every table."""
    t_count, rows, _ = stacked.shape
    pairs = stacked.reshape(t_count, rows // 2, 2, 8)
    return limb.fold_halves(spec, pairs[:, :, 0], pairs[:, :, 1], challenge)


def fold_launch(fold_fn, stream, stacked, challenge, spec: FieldSpec = BN254_FR):
    """Launch K4 through `fold_fn` (``sumcheck_fold`` or its host twin)."""
    field = field_id(spec)
    _check_state(stacked)
    t_count, rows, _ = stacked.shape
    ch = challenge.to(stacked.device).contiguous()
    out = torch.empty((t_count, rows // 2, 8), dtype=torch.int32, device=stacked.device)
    rc = fold_fn(stacked.data_ptr(), t_count * (rows // 2), ch.data_ptr(),
                 out.data_ptr(), field, stream)
    if rc != 0:
        raise RuntimeError(f"sumcheck_fold launch failed: CUDA error {rc}")
    LAUNCHES["sumcheck_fold"] += 1
    return out


def fold_cuda(spec, stacked, challenge):
    field_id(spec)
    if stacked.device.type != "cuda":
        raise ValueError("state must be a CUDA tensor")
    fn = build.bind(build.lib().sumcheck_fold, FOLD_ARGS)
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    return fold_launch(fn, stream, stacked, challenge, spec)


def fold(spec, stacked, challenge):
    """K4: fix the first variable of every stacked table at `challenge`."""
    if stacked.device.type == "cpu":
        return fold_plain(spec, stacked, challenge)
    return fold_cuda(spec, stacked, challenge)
