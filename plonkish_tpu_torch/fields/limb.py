"""Prime-field arithmetic on torch tensors (port of plonkish_tpu/fields/limb.py).

Storage
-------
A batch of field elements is an ``int32[..., 8]`` tensor: eight 32-bit limbs,
little endian, held as raw bit patterns, value in Montgomery form
(``x * R mod p`` with ``R = 2^256``, as in the reference).  The reference's
``uint32[..., 16]`` 16-bit digits repack exactly: ``l[i] = d[2i] | d[2i+1] << 16``
(see ``plonkish_tpu_torch.convert``).

Arithmetic
----------
Torch has no unsigned 32-bit add or shift on the CPU, so the plain arithmetic
unpacks to "digit form": an ``int64[16, N]`` tensor of 16-bit digits, digits
on the leading axis so that every step touches whole contiguous rows.  Every
partial product (< 2^32) and every column sum (< 2^38) fits exactly, and
carries propagate with arithmetic shifts, which also handle borrows.

Multiplication is CIOS Montgomery over 16-bit digits; a single inversion goes
to the host (one Python ``pow``), and batch inversion is Montgomery's trick
over a log-depth prefix-product scan, so no loop over the 2^k elements runs
in Python.  The same functions run on the card, where the CUDA kernels of
``plonkish_tpu_torch.kernels`` take the hot loops; ``to_mont`` and
``from_mont`` on a CUDA tensor of BN254 Fr or Fq are one such kernel
(``kernels/field.py``), and the plain product elsewhere.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..kernels import FIELDS
from ..kernels import field as kfield
from ..utils import timer
from .spec import FieldSpec

L = 8  # 32-bit limbs per element (storage)
D = 16  # 16-bit digits per element (arithmetic)
MASK = 0xFFFF

_CONSTS: Dict[Tuple[int, str], dict] = {}


def _consts(spec: FieldSpec, device) -> dict:
    key = (spec.p, str(device))
    c = _CONSTS.get(key)
    if c is None:
        def col(v, rows=D):
            return torch.tensor(
                [(v >> (16 * i)) & MASK for i in range(rows)],
                dtype=torch.int64, device=device,
            ).reshape(rows, 1)

        c = {
            "p": col(spec.p),
            "p17": col(spec.p, D + 1),
            "n0": (-pow(spec.p, -1, 1 << 16)) % (1 << 16),
            "one": col(spec.r_mod_p),
            "r2": col(spec.r2_mod_p),
            "raw1": col(1),
        }
        _CONSTS[key] = c
    return c


# ---------------------------------------------------------------------------
# Storage <-> digit form
# ---------------------------------------------------------------------------

def unpack(x: torch.Tensor) -> torch.Tensor:
    """int32[..., 8] -> int64[16, N] digits (N = prod of leading dims)."""
    v = x.reshape(-1, L).to(torch.int64) & 0xFFFFFFFF
    d = torch.stack([v & MASK, v >> 16], dim=-1).reshape(-1, D)
    return d.T.contiguous()


def pack(d: torch.Tensor, shape=None) -> torch.Tensor:
    """int64[16, N] exact digits -> int32[N, 8] (or int32[*shape, 8])."""
    t = d.T
    v = t[:, 0::2] | (t[:, 1::2] << 16)
    v = torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)
    if shape is not None:
        v = v.reshape(*shape, L)
    return v.contiguous()


def _norm(t: torch.Tensor) -> torch.Tensor:
    """In-place carry propagation over the digit axis; the top row keeps the
    carry out (negative after a borrow).  On the CPU the rows are walked
    through numpy, whose per-call cost is a fraction of torch's on the small
    tensors of the CPU tests (same integers, same result)."""
    if t.device.type == "cpu":
        a = t.numpy()
        for j in range(a.shape[0] - 1):
            a[j + 1] += a[j] >> 16
            a[j] &= MASK
        return t
    for j in range(t.shape[0] - 1):
        t[j + 1] += t[j] >> 16
        t[j] &= MASK
    return t


def _cond_sub(s: torch.Tensor, c: dict) -> torch.Tensor:
    """[17, N] lazy digits of a value in [0, 2p) -> [16, N] exact value mod p.

    s and s - p are normalised in one pass over the stacked pair."""
    both = _norm(torch.cat([s, s - c["p17"]], dim=1))
    n = s.shape[1]
    return torch.where(both[D, n:] < 0, both[:D, :n], both[:D, n:])


def d_add(a, b, c):
    return _cond_sub(torch.cat([a + b, torch.zeros_like(a[:1])], dim=0), c)


def d_sub(a, b, c):
    """a - b, with a - b + p normalised beside it and picked on a borrow."""
    d = torch.cat([a - b, torch.zeros_like(a[:1])], dim=0)
    n = d.shape[1]
    both = _norm(torch.cat([d, d + c["p17"]], dim=1))
    return torch.where(both[D, :n] < 0, both[:D, n:], both[:D, :n])


def d_neg(a, c):
    return d_sub(torch.zeros_like(a), a, c)


def d_mul(a, b, c):
    """CIOS Montgomery product a*b*R^-1 mod p over 16-bit digits.

    b may be a [16, 1] constant column."""
    n = torch.broadcast_shapes(a.shape[1:], b.shape[1:])[0]  # 0 where a is empty
    t = torch.zeros((2 * D + 1, n), dtype=torch.int64, device=a.device)
    p, n0 = c["p"], c["n0"]
    a = a.expand(D, n)
    b = b.expand(D, n)
    for i in range(D):
        w = t[i: i + D]
        w.addcmul_(a[i: i + 1], b)
        m = (t[i] * n0) & MASK
        w.addcmul_(m.unsqueeze(0), p)
        t[i + 1] += t[i] >> 16
    return _cond_sub(t[D:], c)


def d_redc(t_lazy, c):
    """Lazy 16-digit value T < p*R -> T*R^-1 mod p."""
    n = t_lazy.shape[1]
    t = torch.zeros((2 * D + 1, n), dtype=torch.int64, device=t_lazy.device)
    t[:D] = t_lazy
    p, n0 = c["p"], c["n0"]
    for i in range(D):
        m = (t[i] * n0) & MASK
        t[i: i + D].addcmul_(m.unsqueeze(0), p)
        t[i + 1] += t[i] >> 16
    return _cond_sub(t[D:], c)


def d_is_zero(a):
    return (a == 0).all(dim=0)


def d_const(spec: FieldSpec, value: int, device, mont: bool = True):
    v = value % spec.p
    if mont:
        v = spec.to_mont(v)
    return torch.tensor(
        [(v >> (16 * i)) & MASK for i in range(D)],
        dtype=torch.int64, device=device,
    ).reshape(D, 1)


# ---------------------------------------------------------------------------
# Host conversions (vectorised through bytes, never per element in torch)
# ---------------------------------------------------------------------------

def from_ints(values: Sequence[int], device="cpu") -> torch.Tensor:
    """Python ints (< 2^256) -> int32[n, 8] raw limbs (not Montgomery)."""
    timer.count("ints_in", len(values))
    blob = b"".join(int(v).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(blob, dtype="<i4").reshape(len(values), L)
    return torch.from_numpy(arr.copy()).to(device)


def to_ints(x: torch.Tensor) -> list:
    """int32[..., 8] raw limbs -> flat list of Python ints."""
    blob = x.detach().to("cpu").contiguous().numpy().astype("<i4").tobytes()
    timer.device_read(x)
    timer.count("ints_out", len(blob) // 32)
    return [
        int.from_bytes(blob[32 * i: 32 * i + 32], "little")
        for i in range(len(blob) // 32)
    ]


def const(spec: FieldSpec, value: int, device="cpu", mont: bool = True):
    v = value % spec.p
    if mont:
        v = spec.to_mont(v)
    return from_ints([v], device)[0]


def zeros(shape, device="cpu") -> torch.Tensor:
    return torch.zeros((*shape, L), dtype=torch.int32, device=device)


def one(spec: FieldSpec, shape=(), device="cpu") -> torch.Tensor:
    return const(spec, 1, device).expand(*shape, L).contiguous()


# ---------------------------------------------------------------------------
# Elementwise ops on storage tensors (broadcasting)
# ---------------------------------------------------------------------------

def _binary(fn, spec, a, b):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape)
    b = b.expand(shape)
    c = _consts(spec, a.device)
    return pack(fn(unpack(a), unpack(b), c), shape[:-1])


def add(spec, a, b):
    return _binary(d_add, spec, a, b)


def sub(spec, a, b):
    return _binary(d_sub, spec, a, b)


def mont_mul(spec, a, b):
    if b.dim() == 1 and a.dim() > 1:  # one constant: a [16, 1] column
        c = _consts(spec, a.device)
        return pack(d_mul(unpack(a), unpack(b), c), a.shape[:-1])
    return _binary(d_mul, spec, a, b)


def neg(spec, a):
    return pack(d_neg(unpack(a), _consts(spec, a.device)), a.shape[:-1])


def is_zero(a):
    return (a == 0).all(dim=-1)


def _convert(spec, a, const: str, k: int):
    """a * k * R^-1 mod p: on a CUDA tensor of a field the kernels are built
    for, one launch of csrc/convert.cu; else the plain product by the
    constant column `const` (any a below 2^256 comes out reduced)."""
    if a.device.type == "cuda" and spec.p in FIELDS:
        return kfield.field_convert_cuda(spec, a, k)
    return mont_mul(spec, a, pack(_consts(spec, a.device)[const])[0])


def to_mont(spec, a):
    return _convert(spec, a, "r2", spec.r2_mod_p)


def from_mont(spec, a):
    return _convert(spec, a, "raw1", 1)


def from_canonical_ints(spec, values, device="cpu"):
    """Python ints -> Montgomery int32[n, 8]."""
    return to_mont(spec, from_ints([int(v) % spec.p for v in values], device))


def to_canonical_ints(spec, a) -> list:
    return to_ints(from_mont(spec, a))


def pow_const(spec, a, e: int):
    """a^e elementwise (square and multiply, MSB first)."""
    c = _consts(spec, a.device)
    base = unpack(a)
    acc = c["one"].expand_as(base).clone()
    for bit in bin(e)[2:]:
        acc = d_mul(acc, acc, c)
        if bit == "1":
            acc = d_mul(acc, base, c)
    return pack(acc, a.shape[:-1])


def inv_scalar(spec, a):
    """Inverse of one Montgomery element [8] (0 -> 0), computed on the host."""
    v = to_canonical_ints(spec, a.reshape(1, L))[0]
    w = pow(v, -1, spec.p) if v else 0
    return const(spec, w, a.device)


# ---------------------------------------------------------------------------
# Scans and reductions
# ---------------------------------------------------------------------------

def d_prefix_mul(d, c):
    """Inclusive prefix products along the element axis of [16, n] digits.

    Work-efficient log-depth scan: multiply neighbouring pairs, scan the
    half-size sequence, then fill the even positions (about 2n products)."""
    n = d.shape[1]
    if n == 1:
        return d
    if n % 2:
        d = torch.cat([d, c["one"]], dim=1)
    ev, od = d[:, 0::2], d[:, 1::2]
    ps = d_prefix_mul(d_mul(ev, od, c), c)
    out = torch.empty_like(d)
    out[:, 1::2] = ps
    out[:, 0:1] = ev[:, 0:1]
    if ev.shape[1] > 1:
        out[:, 2::2] = d_mul(ps[:, :-1], ev[:, 1:], c)
    return out[:, :n]


def prefix_mul(spec, a):
    """Inclusive prefix product along axis 0 of [n, 8]."""
    c = _consts(spec, a.device)
    return pack(d_prefix_mul(unpack(a), c), a.shape[:-1])


def d_batch_inv(d, spec):
    """Elementwise inverse of [16, n] digits via Montgomery's trick; zeros
    map to zero (reference limb.batch_inv)."""
    c = _consts(spec, d.device)
    n = d.shape[1]
    z = d_is_zero(d)
    safe = torch.where(z, c["one"], d)
    pre = d_prefix_mul(safe, c)
    suf = d_prefix_mul(safe.flip(1), c).flip(1)
    tinv = unpack(inv_scalar(spec, pack(pre[:, -1:])))
    one = c["one"]
    left = torch.cat([one, pre[:, : n - 1]], dim=1)
    right = torch.cat([suf[:, 1:], one], dim=1)
    out = d_mul(d_mul(left, right, c), tinv, c)
    return torch.where(z, torch.zeros_like(out), out)


def batch_inv(spec, a):
    return pack(d_batch_inv(unpack(a), spec), a.shape[:-1])


def d_sum(d, c):
    """Sum over the element axis of [16, n] Montgomery digits -> [16, 1]."""
    lazy = d.sum(dim=1, keepdim=True)  # exact: n * 2^16 < 2^63
    return d_mul(d_redc(lazy, c), c["r2"], c)


def sum_reduce(spec, a):
    """Modular sum along axis 0 of [n, 8] -> [8]."""
    c = _consts(spec, a.device)
    return pack(d_sum(unpack(a), c))[0]


def fold_halves(spec, lo, hi, x):
    """out = lo + x*(hi - lo), elementwise; x is one element [8]."""
    c = _consts(spec, lo.device)
    dl, dh = unpack(lo), unpack(hi)
    out = d_add(dl, d_mul(d_sub(dh, dl, c), unpack(x), c), c)
    return pack(out, lo.shape[:-1])


def fold_pairs(spec, evals, x):
    """out[i] = e[2i] + x*(e[2i+1] - e[2i]) (multilinear fix_var)."""
    pairs = evals.reshape(-1, 2, L)
    return fold_halves(spec, pairs[:, 0], pairs[:, 1], x)


def scatter_sum(spec, terms, index, m: int):
    """out[..., j, :] = sum of terms[..., c, :] over the c with index[c] = j,
    modulo p (reference limb.scatter_sum, fields/limb.py:785).

    terms: Montgomery int32[..., cells, 8]; index: int64[cells] below m.  The
    digits are added lazily with ``index_add_`` (a column of k terms holds
    digits below k * 2^16) and reduced once, exactly."""
    lead = terms.shape[:-2]
    cells = terms.shape[-2]
    batch = int(np.prod(lead)) if lead else 1
    c = _consts(spec, terms.device)
    d = unpack(terms.reshape(batch * cells, L))
    idx = index.to(terms.device).long()
    idx = (idx.unsqueeze(0) + m * torch.arange(batch, device=terms.device).unsqueeze(1)).reshape(-1)
    lazy = torch.zeros((D, batch * m), dtype=torch.int64, device=terms.device)
    lazy.index_add_(1, idx, d)
    return pack(d_mul(d_redc(lazy, c), c["r2"], c), (*lead, m))
