# BrakedownSpec and its parameter math copied from
# plonkish_tpu/pcs/brakedown_code.py; the code's matrices and encoding ported
# to torch.
"""Brakedown linear codes [GLSTW21] with encoding on the device (port of
plonkish_tpu/pcs/brakedown_code.py).

Spec math (c_n/d_n/openings/dimensions) mirrors
plonkish_backend/src/util/code/brakedown.rs:128-260 exactly.
Every section is written in place into one codeword laid out by column
(``encode_columns``).  On the card each sparse-matrix product is one launch
of csrc/brakedown.cu over all rows of the commitment matrix at once, and so
is the Reed–Solomon base case, as a dense matrix of the points 1..out_len's
powers.  On the CPU, or over a field the kernels are not built for, the
product is a gather, one Montgomery product and a ``limb.scatter_sum``, and
the base case a Horner evaluation.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import random
from typing import List

import torch

from ..fields import limb
from ..fields.spec import FieldSpec
from ..kernels import brakedown as kbrakedown


def _ceil(v: float) -> int:
    return int(math.ceil(v))


def _h(p: float) -> float:
    assert 0.0 < p < 1.0
    q = 1.0 - p
    return -p * math.log2(p) - q * math.log2(q)


@dataclasses.dataclass(frozen=True)
class BrakedownSpec:
    """α, β, r from GLSTW21 Fig. 2 (brakedown.rs:237-260)."""

    lambda_: float
    alpha: float
    beta: float
    r: float

    def delta(self) -> float:
        return self.beta / self.r

    def mu(self) -> float:
        return self.r - 1.0 - self.r * self.alpha

    def nu(self) -> float:
        return self.beta + self.alpha * self.beta + 0.03

    def c_n(self, n: int) -> int:
        a, b = self.alpha, self.beta
        nf = float(n)
        return min(
            max(_ceil(1.28 * b * nf), _ceil(b * nf) + 4),
            _ceil(
                ((110.0 / nf) + _h(b) + a * _h(1.28 * b / a))
                / (b * math.log2(a / (1.28 * b)))
            ),
        )

    def d_n(self, log2_q: int, n: int) -> int:
        a, b, r = self.alpha, self.beta, self.r
        mu, nu = self.mu(), self.nu()
        lq, nf = float(log2_q), float(n)
        return min(
            _ceil((2.0 * b + ((r - 1.0) + 110.0 / nf) / lq) * nf),
            _ceil(
                (r * a * _h(b / r) + mu * _h(nu / mu) + 110.0 / nf)
                / (a * b * math.log2(mu / nu))
            ),
        )

    def num_column_opening(self) -> int:
        return _ceil(-self.lambda_ / math.log2(1.0 - self.delta() / 3.0))

    def num_proximity_testing(self, log2_q: int, n: int, n_0: int) -> int:
        return _ceil(
            self.lambda_
            / (log2_q - math.log2(self.codeword_len(log2_q, n, n_0)))
        )

    def dimensions(self, log2_q: int, n: int, n_0: int):
        assert n > n_0
        a_dims = []
        cur = n
        while True:
            m = _ceil(cur * self.alpha)
            dim = SparseMatrixDimension(cur, m, min(self.c_n(cur), m))
            if dim.n <= n_0:
                break
            a_dims.append(dim)
            cur = m
        b_dims = []
        for a in a_dims:
            n_prime = _ceil(a.m * self.r)
            m_prime = _ceil(a.n * self.r) - a.n - n_prime
            b_dims.append(
                SparseMatrixDimension(
                    n_prime, m_prime, min(self.d_n(log2_q, a.n), m_prime)
                )
            )
        return a_dims, b_dims

    def codeword_len(self, log2_q: int, n: int, n_0: int) -> int:
        a, b = self.dimensions(log2_q, n, n_0)
        return (
            a[0].n
            + sum(x.m for x in a[:-1])
            + b[-1].n
            + sum(x.m for x in b)
        )


# Figure 2 in GLSTW21 (brakedown.rs:253-260).
BRAKEDOWN_SPEC_1 = BrakedownSpec(128.0, 0.1195, 0.0284, 1.420)
BRAKEDOWN_SPEC_2 = BrakedownSpec(128.0, 0.1380, 0.0444, 1.470)
BRAKEDOWN_SPEC_3 = BrakedownSpec(128.0, 0.1780, 0.0610, 1.521)
BRAKEDOWN_SPEC_4 = BrakedownSpec(128.0, 0.2000, 0.0820, 1.640)
BRAKEDOWN_SPEC_5 = BrakedownSpec(128.0, 0.2110, 0.0970, 1.616)
BRAKEDOWN_SPEC_6 = BrakedownSpec(128.0, 0.2380, 0.1205, 1.720)
# Reduced-soundness spec for fast CI (NOT for production use).
BRAKEDOWN_SPEC_TEST = BrakedownSpec(10.0, 0.2380, 0.1205, 1.720)


@dataclasses.dataclass(frozen=True)
class SparseMatrixDimension:
    n: int  # rows
    m: int  # cols
    d: int  # nonzeros per row


class _Matrix:
    """A linear map of the code, applied to every row of the commitment
    matrix at once: ``dot`` is one launch of csrc/brakedown.cu over
    ``by_output`` where the kernels take the batch (kernels/brakedown.py
    ``takes``), and ``dot_plain`` elsewhere."""

    spec: FieldSpec
    dimension: "SparseMatrixDimension"

    def dot(self, batch: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """batch: [B, n, 8] Montgomery -> out [B, m, 8] (allocated when None,
        any strides when given), which it returns."""
        if out is None:
            out = torch.empty((batch.shape[0], self.dimension.m, limb.L), dtype=torch.int32,
                              device=batch.device)
        if kbrakedown.takes(self.spec, batch.device):
            kbrakedown.dot_cuda(self.spec, self.by_output, batch, out)
        else:
            out.copy_(self.dot_plain(batch))
        return out


class SparseMatrix(_Matrix):
    """Random sparse matrix, d distinct nonzero columns per row.

    Stored as flat (row, column, coeff) tensors on `device`, drawn from `rng`
    in the reference's order (per row: its sorted columns, then their
    coefficients), and where the kernel takes them by output
    (``by_output``, sorted once on `device` as the matrix is drawn)."""

    def __init__(self, dimension: SparseMatrixDimension, spec: FieldSpec,
                 rng: random.Random, device="cpu"):
        self.dimension = dimension
        rows, cols, coeffs = [], [], []
        for row in range(dimension.n):
            columns = set()
            while len(columns) < dimension.d:
                columns.add(rng.randrange(dimension.m))
            for col in sorted(columns):
                rows.append(row)
                cols.append(col)
                coeffs.append(rng.randrange(spec.p))
        self.rows = torch.tensor(rows, dtype=torch.int64, device=device)
        self.cols = torch.tensor(cols, dtype=torch.int64, device=device)
        self.coeffs = limb.from_canonical_ints(spec, coeffs, device)
        self.spec = spec
        if kbrakedown.takes(spec, device):
            self.by_output  # sorted here, once, where the matrix is drawn

    @functools.cached_property
    def by_output(self) -> kbrakedown.ByOutput:
        d = self.dimension
        return kbrakedown.by_output(self.rows, self.cols, self.coeffs, d.n, d.m)

    def dot_plain(self, batch: torch.Tensor) -> torch.Tensor:
        """``dot`` as a gather, a product and a scatter-add, on any device."""
        terms = limb.mont_mul(self.spec, batch[:, self.rows], self.coeffs)
        return limb.scatter_sum(self.spec, terms, self.cols, self.dimension.m)


class ReedSolomon(_Matrix):
    """The code's base case (brakedown.rs:324-330): output j = Σ_i input_i ·
    (j + 1)^i, n inputs to m outputs.  The kernel takes it as the dense
    matrix of those powers; ``dot_plain`` is a Horner evaluation."""

    def __init__(self, spec: FieldSpec, n: int, m: int, device="cpu"):
        self.spec = spec
        self.dimension = SparseMatrixDimension(n, m, m)
        self.device = device
        if kbrakedown.takes(spec, device):
            self.by_output  # built here, once

    @functools.cached_property
    def by_output(self) -> kbrakedown.ByOutput:
        d = self.dimension
        return kbrakedown.dense(_vandermonde(self.spec, d.n, d.m, self.device))

    def dot_plain(self, batch: torch.Tensor) -> torch.Tensor:
        return _reed_solomon(self.spec, batch, self.dimension.m)


class Brakedown:
    """A fully-instantiated code: recursive A/B sparse matrix chains with an
    RS base case (brakedown.rs:30-125)."""

    def __init__(self, spec: FieldSpec, row_len: int, codeword_len: int,
                 num_column_opening: int, num_proximity_testing: int,
                 a: List[SparseMatrix], b: List[SparseMatrix]):
        self.spec = spec
        self.row_len = row_len
        self.codeword_len = codeword_len
        self.num_column_opening = num_column_opening
        self.num_proximity_testing = num_proximity_testing
        self.a = a
        self.b = b
        self.rs = ReedSolomon(spec, a[-1].dimension.m, b[-1].dimension.n, a[-1].cols.device)

    @classmethod
    def new_multilinear(cls, spec: FieldSpec, bspec: BrakedownSpec,
                        num_vars: int, n_0: int, rng: random.Random, device="cpu"):
        """Pick row_len minimizing proof size (brakedown.rs:37-68)."""
        assert (1 << num_vars) > n_0
        log2_q = spec.num_bits

        def proof_size(c, r):
            num_ldt = bspec.num_proximity_testing(log2_q, c, n_0)
            return (1 + num_ldt) * c + bspec.num_column_opening() * r

        min_log2_n = (n_0 + 1 - 1).bit_length()
        best = (None, 0)
        for log2_n in range(min_log2_n, num_vars + 1):
            size = proof_size(1 << log2_n, 1 << (num_vars - log2_n))
            if best[0] is None or size < best[0]:
                best = (size, 1 << log2_n)
        row_len = best[1]
        codeword_len = bspec.codeword_len(log2_q, row_len, n_0)
        a_dims, b_dims = bspec.dimensions(log2_q, row_len, n_0)
        a = [SparseMatrix(d, spec, rng, device) for d in a_dims]
        b = [SparseMatrix(d, spec, rng, device) for d in b_dims]
        return cls(
            spec, row_len, codeword_len,
            bspec.num_column_opening(),
            bspec.num_proximity_testing(log2_q, row_len, n_0),
            a, b,
        )

    def encode(self, batch: torch.Tensor) -> torch.Tensor:
        """Encode rows: [B, row_len, 8] -> [B, codeword_len, 8] Montgomery, a
        view of ``encode_columns``."""
        return self.encode_columns(batch).transpose(0, 1)

    def encode_single(self, row: torch.Tensor) -> torch.Tensor:
        return self.encode(row[None])[0]

    def encode_columns(self, batch: torch.Tensor, dot=None) -> torch.Tensor:
        """Encode rows by column: [B, row_len, 8] -> [codeword_len, B, 8]
        Montgomery, contiguous, so that column j is its B values in a row.

        The section layout of brakedown.rs:88-125: input, A-chain outputs,
        RS base output, B-chain outputs.  The codeword is allocated once and
        each matrix writes its section in place, reading its input section
        where it lies: ``dot(matrix, x, out)``, by default the matrix's own
        ``dot``."""
        if dot is None:
            dot = _Matrix.dot
        rows = batch.shape[0]
        out = torch.empty((self.codeword_len, rows, limb.L), dtype=torch.int32,
                          device=batch.device)
        flat = out.transpose(0, 1)  # [B, codeword_len, 8], the layout of encode
        lo, hi = 0, self.row_len  # the section the next A matrix reads
        flat[:, lo:hi] = batch
        for a in self.a[:-1]:  # downward A chain
            m = a.dimension.m
            dot(a, flat[:, lo:hi], flat[:, hi:hi + m])
            lo, hi = hi, hi + m
        tmp = torch.empty((rows, self.a[-1].dimension.m, limb.L), dtype=torch.int32,
                          device=batch.device)
        dot(self.a[-1], flat[:, lo:hi], tmp)
        end = hi + self.rs.dimension.m
        dot(self.rs, tmp, flat[:, hi:end])
        # upward B chain, each reading a slice of the codeword written so far
        a_dims = [m.dimension for m in self.a]
        input_offset = sum(d.n for d in a_dims[:-1]) + a_dims[-1].n + a_dims[-1].m
        for a_dim, b in zip(reversed(a_dims), reversed(self.b)):
            input_offset -= a_dim.m
            n, m = b.dimension.n, b.dimension.m
            dot(b, flat[:, input_offset:input_offset + n], flat[:, end:end + m])
            end += m
        assert end == self.codeword_len, (end, self.codeword_len)
        return out


def _vandermonde(spec: FieldSpec, n: int, out_len: int, device) -> torch.Tensor:
    """The base case's matrix: (j + 1)^i at [j, i], Montgomery int32[out_len, n, 8]."""
    powers = [pow(j + 1, i, spec.p) for j in range(out_len) for i in range(n)]
    return limb.from_canonical_ints(spec, powers, device).reshape(out_len, n, limb.L)


def _reed_solomon(spec: FieldSpec, inputs: torch.Tensor, out_len: int) -> torch.Tensor:
    """target[j] = Σ_i input_i · (j+1)^i — Horner over the inputs, every point
    at once (brakedown.rs:324-330)."""
    dev = inputs.device
    c = limb._consts(spec, dev)
    bsz, n, _ = inputs.shape
    points = limb.unpack(limb.from_canonical_ints(spec, range(1, out_len + 1), dev))
    points = points.repeat(1, bsz)  # [16, B * out_len], batch-major
    acc = torch.zeros_like(points)
    for i in range(n - 1, -1, -1):
        term = limb.unpack(inputs[:, i]).repeat_interleave(out_len, dim=1)
        acc = limb.d_add(limb.d_mul(acc, points, c), term, c)
    return limb.pack(acc, (bsz, out_len))
