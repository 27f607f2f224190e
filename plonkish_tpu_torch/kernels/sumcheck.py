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

K7, the fused sum-check rounds (port-only; it stands for the JAX package's
fused-round programs, plonkish_tpu/piop/sum_check.py:573 and :609), runs
every round of an Evaluations sum-check from a given one to the last in two
launches on one stream: the grid rounds (one cooperative launch, grid-wide
barriers between K3's sums, K6's round message and K4's fold) while a
round's pairs exceed the handover, then the tail (one thread block cluster,
the state in the blocks' shared memory, ``tail_plan``).  Its source
(``csrc/sumcheck_fused.cuh``) is instantiated in the tape's generated source
beside K3.  ``fused_rounds`` takes the same buffers as the per-round path
(piop/sum_check.py ``DeviceFsRun``) and its plain version runs that path's
plain K3, K6 and K4.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import limb
from ..fields.spec import BN254_FR, FieldSpec
from ..piop import fiat_shamir as fs
from ..piop import tape as tape_mod
from . import LAUNCHES, field_id
from . import fiat_shamir as kfs
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
    """The tape evaluated once over whole tensors that hold every t = 1..degree
    side by side (t-major), then summed per t."""
    c = limb._consts(spec, stacked.device)
    t_count, rows, _ = stacked.shape
    s = rows // 2
    flat = limb.unpack(stacked).reshape(16, t_count, rows)
    lo, hi = flat[:, :, 0::2], flat[:, :, 1::2]

    def over_t(first, step):
        """first, first + step, ... (degree values) side by side."""
        vals = [first]
        for _ in range(degree - 1):
            vals.append(limb.d_add(vals[-1], step, c))
        return torch.cat(vals, dim=1)

    id_mul, id_base, id_step = (limb.unpack(v) for v in id_params)
    i = torch.arange(s, dtype=torch.int64, device=stacked.device)
    i_digits = torch.zeros((16, s), dtype=torch.int64, device=stacked.device)
    i_digits[0], i_digits[1] = i & 0xFFFF, i >> 16
    ident = over_t(limb.d_add(limb.d_mul(i_digits, id_mul, c), id_base, c), id_step)
    cvals = limb.unpack(consts)
    regs = [None] * num_regs
    for op, a, b, dst in np.asarray(instrs).tolist():
        if op == tape_mod.OP_ADD:
            v = limb.d_add(regs[a], regs[b], c)
        elif op == tape_mod.OP_MUL:
            v = limb.d_mul(regs[a], regs[b], c)
        elif op == tape_mod.OP_NEG:
            v = limb.d_neg(regs[a], c)
        elif op == tape_mod.OP_CONST:
            v = cvals[:, a: a + 1].expand(16, degree * s)
        elif a == t_count:
            v = ident
        else:
            h = hi[:, a].contiguous()
            v = over_t(h, limb.d_sub(h, lo[:, a], c))
        regs[dst] = v
    lazy = regs[out_reg].expand(16, degree * s).reshape(16, degree, s).sum(dim=2)
    return limb.pack(limb.d_mul(limb.d_redc(lazy, c), c["r2"], c))


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


# ---------------------------------------------------------------------------
# K7: fused rounds
# ---------------------------------------------------------------------------

FUSED_FOLD_PER_THREAD = 4  # csrc/sumcheck_fused.cuh SC_FUSED_FOLD_PER_THREAD
FUSED_PHASES = 8  # csrc/sumcheck_fused.cuh SC_FUSED_PHASES: the timing build's stamps a round
PAIR_BYTES = 64  # a pair of one table: two rows of eight words


def tail_parts_bytes(cluster: int, degree: int) -> int:
    """Block 0's partial sums in the tail's shared memory
    (csrc/sumcheck_fused.cuh sc_tail_parts_words)."""
    return ((cluster * degree * 8 + 3) & ~3) * 4


def tail_plan(tail, tables: int, degree: int):
    """K7's handover, computed at launch from the number of tables and the
    cluster's shared memory: (cluster, cap, handover), where `cap` is the
    pairs of every table that one block's shared memory holds (a power of
    two), the cluster has min(cluster, cap) blocks and holds `handover` =
    blocks * cap pairs; the tail takes the rounds from the first whose pairs
    are at most `handover`, on the cluster while a round has two pairs a
    block or more, then on block 0.  None where one pair of every table does
    not fit a block (the grid rounds then run every round)."""
    cluster = tail.cluster
    budget = tail.smem - tail_parts_bytes(cluster, degree)
    if budget < tables * PAIR_BYTES:
        return None
    cap = 1 << ((budget // (tables * PAIR_BYTES)).bit_length() - 1)
    cluster = min(cluster, cap)
    return cluster, cap, cluster * cap


def fused_rounds_plain(spec, stacked, instrs, consts, num_regs, out_reg, degree, ids, rows,
                       sponge, scal, fixed, out, ch_mont, first, rounds):
    """Rounds first .. first + rounds - 1 in one call, through the plain K3,
    K6 and K4, each round's identity rows read from the stack by its index;
    the buffers advanced in place as K7 advances them.  Returns the state
    after the last fold."""
    for r in range(first, first + rounds):
        sums = sumcheck_round_plain(spec, stacked, instrs, consts, num_regs, out_reg, degree,
                                    ids)
        fs.round_message_plain(spec, degree, sums, scal, sponge, fixed, rows[r: r + 2], out[r],
                               ch_mont, ids)
        stacked = fold_plain(spec, stacked, ch_mont)
    return stacked


def fused_launch(kern, stream, spec, stacked, consts, degree, ids, rows, sponge, scal, fixed,
                 out, ch_mont, first, rounds, times=None):
    """Launch K7 through `kern` (a generated library or its host twin): the
    grid rounds while a round's pairs exceed the handover (``tail_plan``),
    then the tail, each counted in ``LAUNCHES`` where it launches.  The
    second buffer (half the state) and the scratch are allocated here; the
    state is one of K7's two buffers, so it is overwritten (the result may
    be a view of it).  Measurement only (kernel_ab.py): `times`, uint64
    [rounds, FUSED_PHASES, 2] for a library built with the timing macro,
    receives the phase stamps."""
    _check_state(stacked)
    if degree != kern.degree:
        raise ValueError(f"the kernel was generated for degree {kern.degree}, not {degree}")
    t_count, rows_0, _ = stacked.shape
    total = out.shape[0]
    if rounds < 1 or first < 0 or first + rounds > total:
        raise ValueError(f"rounds {first}..{first + rounds - 1} outside the {total} of `out`")
    if rows_0 % (1 << rounds):
        raise ValueError(f"{rows_0} rows do not fold {rounds} times")
    dev = stacked.device
    consts = consts.to(dev).contiguous()
    kfs._check(dev, ids=(ids, (3, 8)), rows=(rows, (total + 1, 3, 8)),
               sponge=(sponge, (kfs.SPONGE_WORDS,)), scal=(scal, (2, 8)),
               fixed=(fixed, (2 * (degree + 1), 8)), out=(out, (total, degree + 2, 8)),
               ch_mont=(ch_mont, (8,)))
    timing = any(key == "timing" and value for key, value in kern.defines)
    if times is not None:
        if not timing:
            raise ValueError("phase stamps need a library built with the timing macro")
        if (times.dtype != torch.int64 or times.device != dev or not times.is_contiguous()
                or tuple(times.shape) != (rounds, FUSED_PHASES, 2)):
            raise ValueError(f"times must be int64[{rounds}, {FUSED_PHASES}, 2] on {dev}")
    elif timing:
        raise ValueError("a timing build writes its stamps: pass `times`")
    s0 = rows_0 // 2
    plan = tail_plan(kern.tail, t_count, degree)
    handover = plan[2] if plan else 0
    grid_rounds = sum(1 for j in range(rounds) if s0 >> j > handover)
    other = torch.empty((t_count * s0 * 8,), dtype=torch.int32, device=dev)
    buffers = (stacked.view(-1), other)
    stamp = times.data_ptr() if times is not None else 0
    if grid_rounds:
        launch = kern.fused
        # every block resident, and no more than round `first` keeps at work
        # (csrc/sumcheck_fused.cuh sc_fused_active); a block's partial sums
        sums = -(-s0 // sumcheck_gen.WARP) * degree
        fold = -(-t_count * s0 // (launch.warps * sumcheck_gen.WARP * FUSED_FOLD_PER_THREAD))
        blocks = max(1, min(launch.resident, max(fold, -(-sums // launch.warps))))
        partial = torch.empty((blocks, degree, 8), dtype=torch.int32, device=dev)
        bar = torch.zeros((1,), dtype=torch.int32, device=dev)
        rc = launch.fn(stacked.data_ptr(), other.data_ptr(), t_count, s0, consts.data_ptr(),
                       ids.data_ptr(), partial.data_ptr(), scal.data_ptr(), sponge.data_ptr(),
                       fixed.data_ptr(), rows.data_ptr(), out.data_ptr(), ch_mont.data_ptr(),
                       bar.data_ptr(), stamp, first, grid_rounds, blocks, launch.warps,
                       launch.capped, stream)
        if rc != 0:
            raise RuntimeError(f"sumcheck_fused launch failed: CUDA error {rc}")
        LAUNCHES["sumcheck_fused"] += 1
    if grid_rounds < rounds:
        cluster, _, _ = plan
        launch, s_t = kern.tail, s0 >> grid_rounds
        blocks = cluster if s_t >= 2 * cluster else 1
        # a block's share of the first tail round, or the pairs block 0
        # gathers (fewer than two a block)
        state_bytes = t_count * PAIR_BYTES * max(s_t // blocks, blocks)
        smem = tail_parts_bytes(blocks, degree) + state_bytes
        src, dst = buffers[grid_rounds % 2], buffers[rounds % 2]
        rc = launch.fn(src.data_ptr(), dst.data_ptr(), t_count, s_t, consts.data_ptr(),
                       ids.data_ptr(), scal.data_ptr(), sponge.data_ptr(), fixed.data_ptr(),
                       rows.data_ptr(), out.data_ptr(), ch_mont.data_ptr(),
                       stamp and stamp + grid_rounds * FUSED_PHASES * 2 * 8,
                       first + grid_rounds, rounds - grid_rounds, blocks, launch.warps, smem,
                       stream)
        if rc != 0:
            raise RuntimeError(f"sumcheck_fused_tail launch failed: CUDA error {rc} ({blocks} "
                               f"blocks in a cluster, {smem} bytes of shared memory)")
        LAUNCHES["sumcheck_fused_tail"] += 1
    final = rows_0 >> rounds
    return buffers[rounds % 2][: t_count * final * 8].view(t_count, final, 8)


def fused_rounds_cuda(spec, stacked, instrs, consts, num_regs, out_reg, degree, ids, rows,
                      sponge, scal, fixed, out, ch_mont, first, rounds):
    field_id(spec)
    if stacked.device.type != "cuda":
        raise ValueError("state must be a CUDA tensor")
    kern = sumcheck_gen.kernel(instrs, num_regs, out_reg, stacked.shape[0], degree, spec)
    stream = torch.cuda.current_stream(stacked.device).cuda_stream
    return fused_launch(kern, stream, spec, stacked, consts, degree, ids, rows, sponge, scal,
                        fixed, out, ch_mont, first, rounds)


def fused_rounds(spec, stacked, instrs, consts, num_regs, out_reg, degree, ids, rows, sponge,
                 scal, fixed, out, ch_mont, first, rounds):
    """K7: rounds first .. first + rounds - 1 of an Evaluations sum-check on
    the state `stacked` ([T, 2s, 8] at round `first`), in place on the
    per-round path's buffers (piop/fiat_shamir.py ``round_message``): `ids`
    round `first`'s K3 identity rows [3, 8], `rows` the whole identity stack
    [k + 1, 3, 8], `sponge`, `scal` and `fixed` K6's, `out` [k, d + 2, 8]
    each round's message and challenge, `ch_mont` [8].  Returns the state
    after the last fold, [T, 2s >> rounds, 8]; on the card the input state is
    consumed as scratch."""
    if stacked.device.type == "cpu":
        return fused_rounds_plain(spec, stacked, instrs, consts, num_regs, out_reg, degree,
                                  ids, rows, sponge, scal, fixed, out, ch_mont, first, rounds)
    return fused_rounds_cuda(spec, stacked, instrs, consts, num_regs, out_reg, degree, ids, rows,
                             sponge, scal, fixed, out, ch_mont, first, rounds)
