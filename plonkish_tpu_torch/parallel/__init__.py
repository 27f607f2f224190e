"""Multi-card parallelism: the mesh context (port of plonkish_tpu/parallel/__init__.py).

The scaling axis is the 2^k hypercube (SURVEY §2.8).  The JAX package runs
one controller over every device and lets GSPMD partition its programs; this
port is SPMD over ``torch.distributed`` instead: one process per rank, every
rank running the same host program with the same seeds, so circuit, witness,
transcript and verifier are replicated.  At the sharded call sites a rank
takes only its contiguous block of rows: block r of an axis of n rows is
``[r*n/w, (r+1)*n/w)``, the high-order index bits, so the ``fix_var`` pairs
(2i, 2i+1) stay on their rank.  Explicit, exact collectives
(``parallel.sharded``) take the place of what GSPMD inserts.

A torch tensor carries no sharding, so a caller asks ``row_block(n)`` for its
block once and keeps the returned ``Block`` (its offset and its mesh) beside
the tensors it cut with it.  ``maybe_shard_rows``/``maybe_shard_axis`` keep
the JAX no-op rules: no mesh, an axis that does not divide, or an axis
shorter than 2*world leave the tensor whole.

Activate with ``use_mesh(mesh)`` (context manager) or ``set_mesh(mesh)``;
``spawn`` starts a group of ranks for the tests, the harness and the dry run,
and ``backend_for`` says which backend a group takes on the cards it sees.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0  # how long one collective may wait for the other ranks

_ACTIVE_MESH = None


@dataclasses.dataclass
class Mesh:
    """One rank's view of a 1-D process group: its rank, the world size, the
    backend, the card or CPU it computes on, and what it sent.

    ``collectives`` and ``bytes`` count the collectives this rank took part
    in and the bytes it put into them; ``taken`` counts the sharded call
    sites it ran (``sum_check``, ``permutation_z``, ``msm``,
    ``brakedown_commit``)."""

    group: Any
    rank: int
    world: int
    backend: str
    device: torch.device
    collectives: int = 0
    bytes: int = 0
    taken: collections.Counter = dataclasses.field(default_factory=collections.Counter)

    def reset_stats(self) -> None:
        self.collectives = 0
        self.bytes = 0
        self.taken.clear()

    def close(self) -> None:
        import torch.distributed as dist

        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None


@dataclasses.dataclass(frozen=True)
class Block:
    """This rank's rows ``[start, stop)`` of an axis of ``total`` rows."""

    start: int
    stop: int
    total: int
    mesh: Mesh

    @property
    def size(self) -> int:
        return self.stop - self.start

    def take(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        assert t.shape[axis] == self.total, (tuple(t.shape), axis, self.total)
        return t.narrow(axis, self.start, self.size)


def set_mesh(mesh) -> None:
    """Install `mesh` as the active mesh (None to disable)."""
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def row_block(n: int, mesh: Optional[Mesh] = None) -> Optional[Block]:
    """This rank's block of an axis of n rows under `mesh` (the active mesh
    when None), or None where the axis stays whole: no mesh, n not divisible
    by the world size, or n < 2 * world (reference
    parallel/__init__.py:47-70)."""
    mesh = _ACTIVE_MESH if mesh is None else mesh
    if mesh is None or n % mesh.world != 0 or n < 2 * mesh.world:
        return None
    size = n // mesh.world
    return Block(mesh.rank * size, (mesh.rank + 1) * size, n, mesh)


def maybe_shard_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of the row axis of `t`; `t` whole under the no-op
    rules of ``row_block``."""
    return maybe_shard_axis(t, 0)


def maybe_shard_axis(t: torch.Tensor, axis: int) -> torch.Tensor:
    """This rank's block of `axis` of `t` (the hypercube axis of a stacked
    table tensor); `t` whole under the no-op rules of ``row_block``, or when
    `t` has no such axis."""
    if t.dim() <= axis:
        return t
    block = row_block(t.shape[axis])
    return t if block is None else block.take(t, axis)


# ---------------------------------------------------------------------------
# Starting a group
# ---------------------------------------------------------------------------

def backend_for(world: int, device) -> str:
    """The backend a group of `world` ranks computing on `device` takes:
    NCCL where every rank has a card of its own, gloo on the CPU or where
    the ranks outnumber the cards and so share one."""
    if torch.device(device).type == "cpu" or world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def rank_device(backend: str, rank: int, device=None) -> torch.device:
    """The device a rank computes on: under NCCL card `rank` (one rank per
    card; NCCL refuses two ranks on one card); under gloo the given device,
    which several ranks may share."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError("NCCL runs on CUDA cards")
        if rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"NCCL rank {rank} needs card {rank}, and {torch.cuda.device_count()} "
                "are visible: ranks that share a card use gloo"
            )
        return torch.device("cuda", rank)
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def start_group(store, world: int, rank: int, backend: str, device=None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the default process group as `rank` of `world`, meeting the other
    ranks through `store` (a ``torch.distributed`` store, so no TCP port),
    with a timeout for every collective of the group.  A group that cannot
    start raises."""
    import torch.distributed as dist

    dev = rank_device(backend, rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this process")
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return Mesh(group=dist.group.WORLD, rank=rank, world=world, backend=backend, device=dev)


def _rank_main(rank, fn, world, backend, device, tmp, timeout_s, threads, args):
    import torch.distributed as dist

    mesh = None
    try:
        if threads:
            torch.set_num_threads(threads)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        mesh = start_group(store, world, rank, backend, device, timeout_s)
        with use_mesh(mesh):
            out = fn(mesh, *args)
        path = os.path.join(tmp, f"rank{rank}.pkl")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".part", path)
    except BaseException:
        # written before the group closes (which fails the peers), for spawn
        # to report every failed rank, not only the first one it sees
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if mesh is not None:
            mesh.close()


class RankError(RuntimeError):
    """One or more ranks of a ``spawn`` failed or ran past its deadline."""


def spawn(fn: Callable, world: int, backend: str, device=None, args: Sequence = (),
          timeout_s: float = DEFAULT_TIMEOUT_S, deadline_s: float = 1800.0,
          threads: Optional[int] = None) -> list:
    """Run ``fn(mesh, *args)`` on `world` new processes, one a rank, and
    return their results in rank order.

    `fn` and its results must pickle (a function of a module).  The ranks
    meet through a FileStore in a temporary directory; each collective of
    the group fails after `timeout_s`, and ranks still running after
    `deadline_s` are killed, so a hang fails the caller instead of stalling
    it.  A rank that raises or exits non-zero fails the whole call (the
    others are terminated) with a RankError that holds the traceback of
    every rank that failed.  `threads` sets each rank's torch CPU threads."""
    import torch.multiprocessing as mp

    if world < 1:
        raise ValueError("world must be at least 1")
    with tempfile.TemporaryDirectory(prefix="plonkish_mesh_") as tmp:
        ctx = mp.start_processes(
            _rank_main,
            args=(fn, world, backend, None if device is None else str(device), tmp,
                  timeout_s, threads, tuple(args)),
            nprocs=world, join=False, start_method="spawn",
        )
        end = time.monotonic() + deadline_s
        failure = None
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > end:
                    failure = TimeoutError(f"ran past the deadline of {deadline_s} s")
                    break
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            failure = e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        if failure is not None:
            errors = []
            for r in range(world):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errors.append(f"rank {r}:\n{f.read()}")
            raise RankError(f"{len(errors)} of the {world} ranks of {fn.__name__} failed "
                            f"({failure!s:.200})\n" + "\n".join(errors)) from failure
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
