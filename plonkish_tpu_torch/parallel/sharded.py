"""Sharded prover steps and the exact collectives (port of
plonkish_tpu/parallel/sharded.py).

The 2^k hypercube axis is the scaling axis (SURVEY §2.8): each rank holds a
contiguous block of rows, ``fix_var`` pairs (2i, 2i+1) stay on their rank,
expression evaluation is elementwise, and only the round messages cross
ranks.  Where the JAX package lets GSPMD insert ``psum`` and
``all_gather``, this module's collectives do it by hand, and exactly:

- a sum of field elements is never a backend ``SUM`` over Montgomery words:
  each rank puts in the 16-bit digits of its partial sums, held in int64,
  and the all-reduced digits are reduced mod p once
  (``all_reduce_field``, the reference's ``_psum_field``);
- tensors of field elements are all-gathered and put together in rank
  order (``all_gather_cat``).

Under gloo a tensor on a card is copied to the host for the collective and
back (gloo runs on the host); under NCCL it stays on its card.  Every
collective adds to the mesh's ``collectives`` and ``bytes``.
"""

from __future__ import annotations

import torch

from ..curves.host import AffinePoint
from ..curves.specs import CurveSpec
from ..fields import limb
from ..fields.spec import FieldSpec
from ..utils import timer
from . import Block, Mesh, row_block, start_group


def make_mesh(backend: str, device=None) -> Mesh:
    """A mesh of one rank in this process over `backend`: ``"nccl"`` (card
    0) or ``"gloo"`` (`device`, the card when None).  The backend is the
    caller's choice; nothing picks another when one fails.  The group meets
    through an in-process store, so it leaves nothing behind.  Groups of
    several ranks start through ``parallel.spawn``."""
    import torch.distributed as dist

    return start_group(dist.HashStore(), 1, 0, backend, device)


def _block(mesh: Mesh, n: int) -> Block:
    """This rank's block of an axis of n rows, which must split over the mesh."""
    block = row_block(n, mesh)
    if block is None:
        raise ValueError(f"{n} rows do not split into blocks of 2 or more over {mesh.world} ranks")
    return block


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """`t` where the backend reads it: the host for gloo, the rank's card for
    NCCL."""
    if mesh.backend == "gloo":
        out = t.cpu().contiguous()
        timer.device_read(t)
        return out
    return t.to(mesh.device).contiguous()


def _count(mesh: Mesh, t: torch.Tensor) -> None:
    mesh.collectives += 1
    mesh.bytes += t.numel() * t.element_size()


def all_reduce_field(spec: FieldSpec, mesh: Mesh, partial: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of Montgomery elements ``int32[..., 8]``, exact:
    one all-reduce of the 16-bit digits in int64 (each rank's digits are
    below 2^16, so the sums stay below world * 2^16), then one reduction
    mod p; returned in Montgomery form on the input's device."""
    import torch.distributed as dist

    shape = partial.shape
    digits = _wire(mesh, limb.unpack(partial))  # int64[16, N], each < 2^16
    _count(mesh, digits)
    dist.all_reduce(digits, op=dist.ReduceOp.SUM, group=mesh.group)
    digits = digits.to(partial.device)
    c = limb._consts(spec, partial.device)
    # value < world * p < p * R: one reduction, then back to Montgomery
    total = limb.d_mul(limb.d_redc(digits, c), c["r2"], c)
    return limb.pack(total, shape[:-1])


def all_gather_cat(mesh: Mesh, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (equal shapes), concatenated along `dim` in rank
    order, on the input's device."""
    import torch.distributed as dist

    local = _wire(mesh, t)
    _count(mesh, local)
    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts, dim=dim).to(t.device)


# ---------------------------------------------------------------------------
# The sharded round step
# ---------------------------------------------------------------------------

def vanilla_gate_eval(spec: FieldSpec, polys: torch.Tensor) -> torch.Tensor:
    """q_l·w_l + q_r·w_r + q_m·w_l·w_r + q_o·w_o + q_c + pi over all rows.

    polys: int32[9, rows, 8] stacked columns (pi, q_l, q_r, q_m, q_o, q_c,
    w_l, w_r, w_o; the vanilla-PLONK layout, reference
    backend/hyperplonk/util.rs:30-49).  Elementwise, so it is local to a
    rank under any row sharding.  Returns Montgomery int32[rows, 8]."""
    c = limb._consts(spec, polys.device)
    pi, q_l, q_r, q_m, q_o, q_c, w_l, w_r, w_o = (limb.unpack(polys[i]) for i in range(9))
    acc = limb.d_mul(q_l, w_l, c)
    acc = limb.d_add(acc, limb.d_mul(q_r, w_r, c), c)
    acc = limb.d_add(acc, limb.d_mul(q_m, limb.d_mul(w_l, w_r, c), c), c)
    acc = limb.d_add(acc, limb.d_mul(q_o, w_o, c), c)
    acc = limb.d_add(acc, q_c, c)
    return limb.pack(limb.d_add(acc, pi, c), polys.shape[1:2])


def sharded_round_step(spec: FieldSpec, mesh: Mesh, polys: torch.Tensor,
                       challenge: torch.Tensor):
    """One sum-check-style prover step over the hypercube rows, sharded:

    1. the gate at every row of this rank's block;
    2. one exact all-reduce of the block's sum: the round message;
    3. K4 (``kernels.sumcheck.fold``) over this rank's block, whose pairs
       are all its own.

    polys: int32[9, rows, 8], whole on every rank (the host program is
    replicated); challenge: Montgomery [8].  Returns (the round sum [8],
    this rank's block of the folded polys [9, rows / 2 / world, 8]).  The
    collective traffic is one all-reduce of 16 digits a round."""
    from ..kernels import sumcheck as ksc

    local = _block(mesh, polys.shape[1]).take(polys, 1).contiguous()
    partial = limb.sum_reduce(spec, vanilla_gate_eval(spec, local))
    total = all_reduce_field(spec, mesh, partial)
    folded = ksc.fold(spec, local, challenge.to(local.device))
    return total, folded


# ---------------------------------------------------------------------------
# The sharded MSM
# ---------------------------------------------------------------------------

def sharded_msm(curve: CurveSpec, mesh: Mesh, scalars: torch.Tensor,
                bases: torch.Tensor) -> AffinePoint:
    """sum_i scalars[i] * bases[i] with the points split over the ranks.

    Each rank runs the whole MSM (``msm_jacobian``: recode, sort, K1 and K2)
    over its block of the points, then one all-gather of the ranks' Jacobian
    ``int32[3, 8]`` results, which are made affine and summed in rank order
    on the host.  The reference gathers each rank's W window sums and
    combines them after the gather; the port's K2 already combines the
    windows on the card, so one point a rank crosses.  The result is the
    same point.  scalars: canonical int32[N, 8]; bases affine int32[N, 2, 8];
    N a multiple of the world size, with 2 points a rank or more."""
    from ..curves import device as cdev
    from ..curves.msm import msm_jacobian

    mesh.taken["msm"] += 1
    block = _block(mesh, scalars.shape[0])
    local = msm_jacobian(curve, block.take(scalars).contiguous(),
                         block.take(bases).contiguous())
    gathered = all_gather_cat(mesh, local[None], 0)
    points = gathered.cpu()  # [world, 3, 8]
    timer.device_read(gathered)
    acc = AffinePoint.identity(curve)
    for p in cdev.jac_to_host(curve, points):
        acc = acc + p
    return acc

