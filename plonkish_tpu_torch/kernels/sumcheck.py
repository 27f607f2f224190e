"""Sum-check kernels K3 (round evaluations) and K4 (fold), with plain versions.

K3 replaces plonkish_tpu/pallas/sumcheck.py::_round_kernel
(pallas/sumcheck.py:159, launched by ``_round_evals_jit``) and K4 replaces
::_fold_kernel (pallas/sumcheck.py:225, launched by ``_fold_tables_jit``).
The CUDA source is ``csrc/sumcheck.cu`` over ``csrc/field.cuh``.

State layout: every live table of the prover stacked as Montgomery
``int32[T, 2s, 8]`` in natural hypercube order, so a fix_var pair is two
neighbouring rows (2i, 2i+1), as in the reference's host path
(sum_check.py:865-868).

K3 evaluates a compiled expression tape (piop/tape.py) at every pair for
t = 1..d, with every leaf at lo + t*(hi - lo), and returns the d sums as
Montgomery ``int32[d, 8]``.  Leaf operands of OP_LOAD index the stacked rows;
the operand T selects the identity polynomial, whose value at pair i is
``base + i * mul + (t - 1) * step`` (``id_params``: mul as raw digits of
2^(r+1) * R^2 mod p, base and step Montgomery).

K4 folds every table at once: new[i] = lo + c * (hi - lo).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import limb
from ..fields.spec import BN254_FR, FieldSpec
from ..piop import tape as tape_mod
from . import LAUNCHES
from . import build

ROUND_THREADS = 128
ROUND_MAX_BLOCKS = 1056  # 8 blocks on each of the card's 132 SMs


def _check_spec(spec: FieldSpec):
    if spec is not BN254_FR:
        raise NotImplementedError("the sum-check kernels are built for BN254 Fr")


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


ROUND_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
FOLD_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


def round_launch(round_fn, stream, stacked, instrs, consts, num_regs, out_reg,
                 degree, id_params):
    """Launch K3 through `round_fn` (``sumcheck_round`` or its host twin)."""
    _check_state(stacked)
    dev = stacked.device
    t_count, rows, _ = stacked.shape
    instrs_t = torch.as_tensor(np.ascontiguousarray(instrs, dtype=np.int32)).to(dev)
    consts = consts.to(dev).contiguous()
    ids = torch.stack([v.to(dev) for v in id_params]).contiguous()
    s = rows // 2
    blocks = max(1, min(ROUND_MAX_BLOCKS, -(-s // ROUND_THREADS)))
    partial = torch.empty((blocks, degree, 8), dtype=torch.int32, device=dev)
    out = torch.empty((degree, 8), dtype=torch.int32, device=dev)
    rc = round_fn(stacked.data_ptr(), t_count, s, instrs_t.data_ptr(),
                  instrs_t.shape[0], consts.data_ptr(), num_regs, out_reg, degree,
                  ids.data_ptr(), blocks, ROUND_THREADS, partial.data_ptr(),
                  out.data_ptr(), stream)
    if rc == -1:
        raise ValueError(
            f"tape too large for the round kernel (SC_MAX_* in csrc/sumcheck.cu): "
            f"{num_regs} registers, degree {degree}, {t_count} tables"
        )
    if rc != 0:
        raise RuntimeError(f"sumcheck_round launch failed: CUDA error {rc}")
    LAUNCHES["sumcheck_round"] += 1
    return out


def sumcheck_round_cuda(spec, stacked, instrs, consts, num_regs, out_reg,
                        degree, id_params):
    _check_spec(spec)
    if stacked.device.type != "cuda":
        raise ValueError("state must be a CUDA tensor")
    fn = build.bind(build.lib().sumcheck_round, ROUND_ARGS)
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    return round_launch(fn, stream, stacked, instrs, consts, num_regs, out_reg,
                        degree, id_params)


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


def fold_launch(fold_fn, stream, stacked, challenge):
    """Launch K4 through `fold_fn` (``sumcheck_fold`` or its host twin)."""
    _check_state(stacked)
    t_count, rows, _ = stacked.shape
    ch = challenge.to(stacked.device).contiguous()
    out = torch.empty((t_count, rows // 2, 8), dtype=torch.int32, device=stacked.device)
    rc = fold_fn(stacked.data_ptr(), t_count * (rows // 2), ch.data_ptr(),
                 out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"sumcheck_fold launch failed: CUDA error {rc}")
    LAUNCHES["sumcheck_fold"] += 1
    return out


def fold_cuda(spec, stacked, challenge):
    _check_spec(spec)
    if stacked.device.type != "cuda":
        raise ValueError("state must be a CUDA tensor")
    fn = build.bind(build.lib().sumcheck_fold, FOLD_ARGS)
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    return fold_launch(fn, stream, stacked, challenge)


def fold(spec, stacked, challenge):
    """K4: fix the first variable of every stacked table at `challenge`."""
    if stacked.device.type == "cpu":
        return fold_plain(spec, stacked, challenge)
    return fold_cuda(spec, stacked, challenge)
