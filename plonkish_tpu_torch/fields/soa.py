"""Struct-of-arrays field arithmetic on torch tensors (port of
plonkish_tpu/fields/soa.py): a batch of field elements is a LIST of 16 digit
tensors, each ``int64[*batch]`` holding one 16-bit digit of every element.

This is the arithmetic that the ``mont_mul`` chain probe chains
(``kernels/probe.py``), kept as the plain PyTorch version of the two
multipliers the probe compares on the card:

- ``mont_mul``: schoolbook 16 x 16-bit digit products in integers, exact carry
  chains, one-shot REDC with p' = -p^-1 mod R (the reference's u32 path);
- ``mont_mul_f32``: the same product with every partial product done in
  float32 over 8-bit digits.  A byte product is < 2^16 and a schoolbook column
  of at most 32 of them is < 2^21, so every float32 value is an exact integer
  below 2^24; carries and the conditional subtraction stay in integers.  The
  two agree bit for bit.

Digits are int64 because torch has no unsigned 32-bit arithmetic on the CPU;
every bound of the reference (columns < 2^21, paired bytes < 2^30) holds
unchanged.  The caller names the multiplier; there is no environment switch.

Same mathematics as ``fields/limb.py``: Montgomery form with R = 2^256.
``from_tensor``/``to_tensor`` convert from and to the port's interchange
format, Montgomery ``int32[..., 8]`` limbs; ``from_wide``/``to_wide`` from and
to the digit-major ``int64[16, ...]`` form of ``limb.unpack``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .spec import FieldSpec, int_to_digits

L = 16  # 16-bit digits per element
MASK = 0xFFFF
W16 = 16
B8 = 2 * L  # byte digits per element
MASK8 = 0xFF

Digits = List[torch.Tensor]


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def from_tensor(x: torch.Tensor) -> Digits:
    """int32[..., 8] limbs -> list of 16 digit tensors int64[...]."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    out = []
    for i in range(L // 2):
        out.append(v[..., i] & MASK)
        out.append(v[..., i] >> W16)
    return out


def to_tensor(ds: Sequence[torch.Tensor]) -> torch.Tensor:
    """List of 16 exact digit tensors -> int32[..., 8] limbs."""
    v = torch.stack([ds[2 * i] | (ds[2 * i + 1] << W16) for i in range(L // 2)], dim=-1)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def from_wide(x: torch.Tensor) -> Digits:
    """[16, ...] digit-major tensor -> list of 16 digit tensors."""
    return [x[i] for i in range(L)]


def to_wide(ds: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(ds), dim=0)


def zeros_like(ds: Digits) -> Digits:
    return [torch.zeros_like(d) for d in ds]


def const(spec: FieldSpec, value: int, ref: Digits) -> Digits:
    """Montgomery constant broadcast against a reference digit list."""
    digs = int_to_digits(spec.to_mont(value % spec.p))
    return [torch.full_like(ref[0], int(d)) for d in digs]


def select(cond: torch.Tensor, a: Digits, b: Digits) -> Digits:
    """Where cond (bool tensor) pick digits of a else b."""
    return [torch.where(cond, x, y) for x, y in zip(a, b)]


# ---------------------------------------------------------------------------
# Carries, add, sub, neg
# ---------------------------------------------------------------------------

def _carry_chain(ds: Digits) -> Digits:
    """Exact carry propagation over lazy digits.  Returns len(ds) + 1 digits
    (the final carry in the last slot)."""
    out = []
    carry = None
    for d in ds:
        v = d if carry is None else d + carry
        out.append(v & MASK)
        carry = v >> W16
    out.append(carry)
    return out


def _sub_borrow(a: Digits, b: Digits):
    """a - b with a borrow chain; returns (digits, borrow flag tensor)."""
    out = []
    borrow = torch.zeros_like(a[0])
    for x, y in zip(a, b):
        v = x + 0x10000 - y - borrow
        out.append(v & MASK)
        borrow = 1 - (v >> W16)
    return out, borrow


def _p_digits(spec: FieldSpec, ref: torch.Tensor) -> Digits:
    return [torch.full_like(ref, int(d)) for d in spec.p_digits]


def _cond_sub_p(spec: FieldSpec, ds: Digits) -> Digits:
    diff, borrow = _sub_borrow(ds, _p_digits(spec, ds[0]))
    return select(borrow != 0, ds, diff)  # borrowed => ds < p


def add(spec: FieldSpec, a: Digits, b: Digits) -> Digits:
    s = _carry_chain([x + y for x, y in zip(a, b)])
    # sum < 2p < 2^255, so the top carry is always 0
    return _cond_sub_p(spec, s[:L])


def sub(spec: FieldSpec, a: Digits, b: Digits) -> Digits:
    diff, borrow = _sub_borrow(a, b)
    wrapped = _carry_chain([x + y for x, y in zip(diff, _p_digits(spec, a[0]))])[:L]
    return select(borrow != 0, wrapped, diff)


def is_zero(a: Digits) -> torch.Tensor:
    acc = a[0]
    for d in a[1:]:
        acc = acc | d
    return acc == 0


def neg(spec: FieldSpec, a: Digits) -> Digits:
    diff, _ = _sub_borrow(_p_digits(spec, a[0]), a)
    return select(is_zero(a), zeros_like(diff), diff)


# ---------------------------------------------------------------------------
# Integer digit products
# ---------------------------------------------------------------------------

def _acc(cols, k, v):
    cols[k] = v if cols[k] is None else cols[k] + v


def _filled(cols, ref):
    z = torch.zeros_like(ref)
    return [z if c is None else c for c in cols]


def _mul_columns(a: Digits, b) -> Digits:
    """Schoolbook 16 x 16 digit product as 2L + 1 lazy columns, each
    < 32 * 2^16 = 2^21: the 16-bit halves of every partial product land in
    their columns.  b may hold Python ints (a fixed operand)."""
    cols = [None] * (2 * L + 1)
    for i in range(L):
        for j in range(L):
            p = a[i] * b[j]
            _acc(cols, i + j, p & MASK)
            _acc(cols, i + j + 1, p >> W16)
    return _filled(cols, a[0])


def _mul_columns_low(a: Digits, b) -> Digits:
    """Low L columns only (mod R), lazy < 2^21."""
    cols = [None] * L
    for i in range(L):
        for j in range(L - i):
            p = a[i] * b[j]
            _acc(cols, i + j, p & MASK)
            if i + j + 1 < L:
                _acc(cols, i + j + 1, p >> W16)
    return _filled(cols, a[0])


def _sqr_columns(a: Digits) -> Digits:
    """Schoolbook square: each cross product a_i * a_j (i < j) once, the
    columns doubled, then the diagonal terms: 136 products against 256."""
    cols = [None] * (2 * L + 1)
    for i in range(L):
        for j in range(i + 1, L):
            p = a[i] * a[j]
            _acc(cols, i + j, p & MASK)
            _acc(cols, i + j + 1, p >> W16)
    z = torch.zeros_like(a[0])
    cols = [z if c is None else c + c for c in cols]
    for i in range(L):
        p = a[i] * a[i]
        _acc(cols, 2 * i, p & MASK)
        _acc(cols, 2 * i + 1, p >> W16)
    return cols


def _redc(spec: FieldSpec, t: Digits) -> Digits:
    """One-shot Montgomery reduction of exact double-width digits t
    (2L + 1 entries) -> T * R^-1 mod p."""
    pp = [int(d) for d in spec.p_prime_digits]
    m = _carry_chain(_mul_columns_low(t[:L], pp))[:L]  # exact mod R
    pd = [int(d) for d in spec.p_digits]
    mp = _mul_columns(m, pd)  # 2L + 1 lazy
    u = _carry_chain([x + y for x, y in zip(t, mp)])[: 2 * L + 1]
    # (T + M p) / R < 2p: digits L .. 2L - 1 (digit 2L is zero)
    return _cond_sub_p(spec, u[L: 2 * L])


def mont_mul(spec: FieldSpec, a: Digits, b: Digits) -> Digits:
    """a * b * R^-1 mod p with integer digit products."""
    t = _carry_chain(_mul_columns(a, b))[: 2 * L + 1]  # exact
    return _redc(spec, t)


def mont_sqr(spec: FieldSpec, a: Digits) -> Digits:
    """a^2 * R^-1 mod p."""
    t = _carry_chain(_sqr_columns(a))[: 2 * L + 1]  # exact
    return _redc(spec, t)


# ---------------------------------------------------------------------------
# float32 digit products
# ---------------------------------------------------------------------------

def _to_bytes_f32(a: Digits) -> List[torch.Tensor]:
    """L 16-bit digit tensors -> 2L float32 byte-digit tensors (exact)."""
    out = []
    for d in a:
        out.append((d & MASK8).to(torch.float32))
        out.append((d >> 8).to(torch.float32))
    return out


def _spec_bytes_f32(digits) -> List[float]:
    """Fixed digits (p, p') as Python floats, two bytes per digit."""
    out = []
    for d in digits:
        out.append(float(int(d) & MASK8))
        out.append(float(int(d) >> 8))
    return out


def _mul_columns_f32(a8, b8, nlo=None) -> List[torch.Tensor]:
    """Schoolbook byte product in float32: column k = sum_{i+j=k} a8_i * b8_j,
    at most 32 terms < 2^16 each, so < 2^21 and exact.  Skips columns >= nlo
    when only the low part (mod 256^nlo) is needed; fixed (Python float)
    entries of b8 equal to 0 are left out."""
    n, m = len(a8), len(b8)
    hi = n + m - 1 if nlo is None else nlo
    cols = [None] * hi
    for i in range(n):
        for j in range(min(m, hi - i)):
            bj = b8[j]
            if isinstance(bj, float) and bj == 0.0:
                continue
            _acc(cols, i + j, a8[i] * bj)
    return _filled(cols, a8[0])


def _sqr_columns_f32(a8) -> List[torch.Tensor]:
    """float32 byte square: cross products once, columns doubled, diagonals
    added; < 2^21 + 2^16, exact."""
    n = len(a8)
    cols = [None] * (2 * n - 1)
    for i in range(n):
        for j in range(i + 1, n):
            _acc(cols, i + j, a8[i] * a8[j])
    z = torch.zeros_like(a8[0])
    cols = [z if c is None else c + c for c in cols]
    for i in range(n):
        _acc(cols, 2 * i, a8[i] * a8[i])
    return cols


def _pair_bytes_u32(cols) -> Digits:
    """Exact float32 base-256 columns -> lazy base-2^16 integer digits:
    d[k] = c[2k] + c[2k+1] * 256 < 2^21 + 2^29 < 2^30."""
    c = [x.to(torch.int64) for x in cols]
    ds = [c[k] + (c[k + 1] << 8) for k in range(0, len(c) - 1, 2)]
    if len(c) % 2:
        ds.append(c[-1])
    return ds


def _redc_f32(spec: FieldSpec, t: Digits) -> Digits:
    """One-shot REDC with the two fixed-operand products (* p' mod R, * p)
    in float32 too.  Same result as ``_redc`` bit for bit."""
    pp8 = _spec_bytes_f32(spec.p_prime_digits)
    t8 = _to_bytes_f32(t[:L])
    m_cols = _mul_columns_f32(t8, pp8, nlo=B8)  # low half: mod 2^256
    m = _carry_chain(_pair_bytes_u32(m_cols))[:L]  # exact mod R
    pd8 = _spec_bytes_f32(spec.p_digits)
    mp = _pair_bytes_u32(_mul_columns_f32(_to_bytes_f32(m), pd8))
    u = _carry_chain(
        [x + y for x, y in zip(t, mp)] + list(t[len(mp):])
    )[: 2 * L + 1]
    return _cond_sub_p(spec, u[L: 2 * L])


def mont_mul_f32(spec: FieldSpec, a: Digits, b: Digits) -> Digits:
    """Bit-identical to ``mont_mul``, products in float32."""
    a8 = _to_bytes_f32(a)
    b8 = _to_bytes_f32(b)
    t = _carry_chain(_pair_bytes_u32(_mul_columns_f32(a8, b8)))[: 2 * L + 1]
    return _redc_f32(spec, t)


def mont_sqr_f32(spec: FieldSpec, a: Digits) -> Digits:
    a8 = _to_bytes_f32(a)
    t = _carry_chain(_pair_bytes_u32(_sqr_columns_f32(a8)))[: 2 * L + 1]
    return _redc_f32(spec, t)
