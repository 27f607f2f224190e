"""The Brakedown commit on the card: the code's sparse products
(``csrc/brakedown.cu``) and the Keccak-256 column hashes and Merkle levels
(``csrc/merkle.cu``), for ``pcs/brakedown_code.py`` and ``pcs/brakedown.py``.

A matrix of the code is kept by output (``ByOutput``), sorted once where it
is drawn.  ``dot_launch`` writes ``out[b, j] = sum_e coeff[e] * x[b, index[e]]``
into an output the caller gives, any strides, so that every section of the
codeword is written in place.  ``column_hashes`` and ``merkle_levels`` fill
one tensor of the tree's nodes, int32[2 * width - 1, 8]: the leaves (the
columns' digests, zero digests up to ``width``, a power of two), then each
level, the root last.

Each launch goes on the current stream, with no synchronisation and no read
back; ``LAUNCHES["brakedown_dot"]`` and ``LAUNCHES["keccak_messages"]`` count
them.  The ``*_launch`` functions take the entry point, so the CPU tests run
them with its host twin (``csrc/cpu_twin.cpp``).  The package's own paths
take these kernels where ``takes`` says so (for the hashes, on the card) and
their plain versions elsewhere (``SparseMatrix.dot_plain``,
``pcs/brakedown.py``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..fields.spec import FieldSpec
from . import FIELDS, LAUNCHES, build, field_id

THREADS = 128

DOT_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
HASH_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def takes(spec: FieldSpec, device) -> bool:
    """Whether the encoding of `spec` on `device` goes through
    csrc/brakedown.cu: on the card, in a field the kernels are built for."""
    return torch.device(device).type == "cuda" and spec.p in FIELDS


@dataclasses.dataclass(frozen=True)
class ByOutput:
    """An n x m matrix by output: output j's nonzeros are the input indices
    ``index[offsets[j]:offsets[j + 1]]`` with the Montgomery coefficients
    ``coeff`` at the same places."""
    offsets: torch.Tensor  # int32[m + 1]
    index: torch.Tensor  # int32[nnz]
    coeff: torch.Tensor  # int32[nnz, 8]
    n: int
    m: int


def by_output(rows: torch.Tensor, cols: torch.Tensor, coeffs: torch.Tensor, n: int,
              m: int) -> ByOutput:
    """The layout of the nonzeros (rows[e], cols[e], coeffs[e]), on their
    device: sorted by column, then row."""
    order = torch.argsort(cols * n + rows)
    offsets = torch.zeros(m + 1, dtype=torch.int32, device=cols.device)
    offsets[1:] = torch.cumsum(torch.bincount(cols, minlength=m), 0)
    return ByOutput(offsets, rows[order].to(torch.int32), coeffs[order].contiguous(), n, m)


def dense(coeffs: torch.Tensor) -> ByOutput:
    """The layout of a dense matrix given as Montgomery int32[m, n, 8], the
    coefficient of input i in output j at [j, i]."""
    m, n, _ = coeffs.shape
    dev = coeffs.device
    offsets = (torch.arange(m + 1, device=dev) * n).to(torch.int32)
    index = torch.arange(n, dtype=torch.int32, device=dev).repeat(m)
    return ByOutput(offsets, index, coeffs.reshape(m * n, 8).contiguous(), n, m)


def _strides(t: torch.Tensor, what: str):
    """A [rows, len, 8] int32 tensor's row and element strides, in elements."""
    if t.dtype != torch.int32 or t.dim() != 3 or t.shape[2] != 8:
        raise ValueError(f"{what} must be int32[rows, len, 8], got {t.dtype} {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
        raise ValueError(f"{what}'s elements must be whole and 16-byte aligned")
    return t.stride(0) // 8, t.stride(1) // 8


def dot_launch(dot_fn, stream, spec: FieldSpec, mat: ByOutput, x: torch.Tensor,
               out: torch.Tensor) -> None:
    """out [rows, m, 8] = x [rows, n, 8] times the matrix, Montgomery, through
    `dot_fn` (``brakedown_dot`` or its host twin)."""
    rows = x.shape[0]
    if x.shape[:2] != (rows, mat.n) or out.shape[:2] != (rows, mat.m):
        raise ValueError(f"a {mat.n} x {mat.m} matrix takes [rows, {mat.n}, 8] to "
                         f"[rows, {mat.m}, 8]; got {tuple(x.shape)} and {tuple(out.shape)}")
    if rows == 0 or mat.m == 0:
        return
    in_sb, in_si = _strides(x, "x")
    out_sb, out_sj = _strides(out, "out")
    rc = dot_fn(x.data_ptr(), in_sb, in_si, out.data_ptr(), out_sb, out_sj,
                mat.offsets.data_ptr(), mat.index.data_ptr(), mat.coeff.data_ptr(), mat.m, rows,
                field_id(spec), THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"brakedown_dot launch failed: error {rc}")
    LAUNCHES["brakedown_dot"] += 1


def tree_width(codeword_len: int) -> int:
    """The leaves of the tree over `codeword_len` columns: a power of two."""
    return 1 << (codeword_len - 1).bit_length()


def _hash(hash_fn, stream, words: torch.Tensor, lanes: int, n: int, width: int,
          out: torch.Tensor) -> None:
    rc = hash_fn(words.data_ptr(), lanes, n, width, out.data_ptr(), THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"keccak_messages launch failed: error {rc}")
    LAUNCHES["keccak_messages"] += 1


def column_hashes_launch(hash_fn, stream, canon: torch.Tensor) -> torch.Tensor:
    """The tree's nodes, int32[2 * width - 1, 8], with its leaves filled: the
    digest of each column of the canonical codeword canon [codeword_len,
    rows, 8] (contiguous: column j's message is its rows' 32-byte values, row
    after row), then zero digests."""
    if canon.dtype != torch.int32 or canon.dim() != 3 or canon.shape[2] != 8:
        raise ValueError(f"canon must be int32[codeword_len, rows, 8], got {tuple(canon.shape)}")
    if not canon.is_contiguous():
        raise ValueError("canon must be contiguous: its columns are the messages")
    cw, rows, _ = canon.shape
    width = tree_width(cw)
    nodes = torch.empty((2 * width - 1, 8), dtype=torch.int32, device=canon.device)
    _hash(hash_fn, stream, canon, 4 * rows, cw, width, nodes)
    return nodes


def merkle_levels_launch(hash_fn, stream, nodes: torch.Tensor) -> None:
    """Every level above the leaves of `nodes`, in place: each node the
    digest of its two children's 64 bytes."""
    width = (nodes.shape[0] + 1) // 2
    offset = 0
    while width > 1:
        _hash(hash_fn, stream, nodes[offset:], 8, width // 2, width // 2,
              nodes[offset + width:])
        offset += width
        width //= 2


@functools.lru_cache(maxsize=None)
def _dot():
    return build.bind(build.lib().brakedown_dot, DOT_ARGS)


@functools.lru_cache(maxsize=None)
def _keccak():
    return build.bind(build.lib().keccak_messages, HASH_ARGS)


def _stream(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError("the Brakedown kernels take CUDA tensors")
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def dot_cuda(spec: FieldSpec, mat: ByOutput, x: torch.Tensor, out: torch.Tensor) -> None:
    dot_launch(_dot(), _stream(x), spec, mat, x, out)


def column_hashes_cuda(canon: torch.Tensor) -> torch.Tensor:
    return column_hashes_launch(_keccak(), _stream(canon), canon)


def merkle_levels_cuda(nodes: torch.Tensor) -> None:
    merkle_levels_launch(_keccak(), _stream(nodes), nodes)
