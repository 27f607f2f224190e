"""Number-theoretic transform over the port's digit form (port of
plonkish_tpu/poly/ntt.py).

The same transform as the reference: the Stockham autosort formulation of a
decimation-in-frequency NTT, natural order in and natural order out, with
the reference's twiddles.  Stage t views the ``[16, n]`` digits as
``[16, n / 2^t, 2^t]`` (rows of the sub-transforms, sub-transform columns),
splits the rows into halves a and b, and writes ``a + b`` and
``(a - b) * w_t^j`` side by side along the column axis, so no bit-reversal
pass is needed.  The input is unpacked once and packed once; every stage is
a few whole-tensor passes of ``limb.d_add``/``d_sub``/``d_mul``.

The reference builds its twiddle tables and its coset powers in Python
loops of n steps, which at the 2^22 points of a k = 20 univariate prove
takes minutes.  Here both are built on the tensor's device by doubling
(``poly.univariate.powers_tensor``): stage t's twiddles ``w_t^j = w^(j 2^t)``
are every 2^t-th entry of one table of the first n/2 powers of w, kept per
(field, log n, inverse, device).
"""

from __future__ import annotations

import functools

import torch

from ..fields import limb
from ..fields.host import Fp
from ..fields.spec import FieldSpec
from .univariate import powers_tensor

# multiplicative generators (smallest; verified by order checks in tests)
_GENERATORS = {}


def _two_adicity(p: int) -> int:
    t, s = p - 1, 0
    while t % 2 == 0:
        t //= 2
        s += 1
    return s


def root_of_unity(spec: FieldSpec, log_n: int) -> int:
    """Primitive 2^log_n-th root of unity in spec's field."""
    s = _two_adicity(spec.p)
    assert log_n <= s, f"field has 2-adicity {s} < {log_n}"
    g = _GENERATORS.get(spec.p)
    if g is None:
        for cand in (3, 5, 7, 10, 11, 13):
            w = pow(cand, (spec.p - 1) >> s, spec.p)
            if pow(w, 1 << (s - 1), spec.p) != 1:
                g = cand
                break
        _GENERATORS[spec.p] = g
    w = pow(g, (spec.p - 1) >> s, spec.p)
    return pow(w, 1 << (s - log_n), spec.p)


_PLANS = {}


def plan(spec: FieldSpec, log_n: int, inverse: bool, device):
    """(the first n/2 powers of the transform's root as Montgomery
    ``int32[n/2, 8]``, n^-1 as ``[16, 1]`` digits), built on `device` once
    per (field, log n, inverse, device)."""
    device = torch.device(device)
    key = (spec.p, log_n, inverse, str(device))
    entry = _PLANS.get(key)
    if entry is None:
        n = 1 << log_n
        w = root_of_unity(spec, log_n)
        if inverse:
            w = pow(w, spec.p - 2, spec.p)
        base = powers_tensor(spec, Fp(w, spec), max(n // 2, 1), device)
        n_inv = limb.d_const(spec, pow(n, spec.p - 2, spec.p), device)
        entry = _PLANS[key] = (base, n_inv)
    return entry


def stage_twiddles(spec: FieldSpec, log_n: int, inverse: bool, t: int, device) -> torch.Tensor:
    """Stage t's twiddles w_t^j, j < n / 2^(t+1), as Montgomery
    ``int32[n / 2^(t+1), 8]``: the reference's ``_plan`` table of stage t
    holds each of them once per sub-transform column."""
    base, _ = plan(spec, log_n, inverse, device)
    return base[:: 1 << t]


def d_ntt(spec: FieldSpec, d: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward or inverse NTT of ``[16, n]`` Montgomery digits, natural order
    in and out."""
    n = d.shape[1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    D = limb.D
    c = limb._consts(spec, d.device)
    _, n_inv = plan(spec, log_n, inverse, d.device)
    x = d.reshape(D, n, 1)
    for t in range(log_n):
        l = n >> (t + 1)
        cols = 1 << t
        a = x[:, :l].reshape(D, l * cols)
        b = x[:, l:].reshape(D, l * cols)
        tw = limb.unpack(stage_twiddles(spec, log_n, inverse, t, d.device))  # [16, l]
        if cols > 1:
            tw = tw.unsqueeze(2).expand(D, l, cols).reshape(D, l * cols)
        lo = limb.d_add(a, b, c)
        hi = limb.d_mul(limb.d_sub(a, b, c), tw, c)
        del a, b, tw
        x = torch.cat([lo.view(D, l, cols), hi.view(D, l, cols)], dim=2)
        del lo, hi
    x = x.reshape(D, n)
    if inverse:
        x = limb.d_mul(x, n_inv, c)
    return x


def ntt(spec: FieldSpec, values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Forward/inverse NTT of a Montgomery ``int32[n, 8]`` tensor (the
    reference's signature)."""
    return limb.pack(d_ntt(spec, limb.unpack(values), inverse))


@functools.lru_cache(maxsize=8)
def _coset_powers(spec: FieldSpec, s: int, n: int, device: str) -> torch.Tensor:
    return powers_tensor(spec, Fp(s, spec), n, device)


def coset_powers(spec: FieldSpec, shift: int, n: int, device, invert: bool = False) -> torch.Tensor:
    """1, s, s^2, ..., s^(n-1) for s = shift (or shift^-1), Montgomery
    ``int32[n, 8]`` on `device` (a few tables are kept per process)."""
    s = pow(shift, spec.p - 2, spec.p) if invert else (shift % spec.p)
    return _coset_powers(spec, s, n, str(torch.device(device)))


def d_coset_scale(spec: FieldSpec, d: torch.Tensor, shift: int, invert: bool = False):
    """``[16, n]`` digits times shift^i (or shift^-i) along the element axis."""
    c = limb._consts(spec, d.device)
    pw = limb.unpack(coset_powers(spec, shift, d.shape[1], d.device, invert))
    return limb.d_mul(d, pw, c)


def coset_scale(spec: FieldSpec, values: torch.Tensor, shift: int, invert: bool = False):
    """Multiply values[i] by shift^i (Montgomery in/out): turns an NTT over
    H into one over the coset shift·H (quotient-polynomial evaluation)."""
    return limb.pack(d_coset_scale(spec, limb.unpack(values), shift, invert))
