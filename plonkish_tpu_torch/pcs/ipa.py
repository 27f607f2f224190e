"""Multilinear IPA (Bulletproofs-style inner product argument; port of
plonkish_tpu/pcs/ipa.py).

Mirrors plonkish_backend/src/pcs/multilinear/ipa.rs:
hash-to-curve generator basis, k rounds of L/R commitments + challenge folding
of (bases, coeffs, zs=eq(point)), final (g_k, c) with the verifier rebuilding
h(X) = Π(1 + ξ_i X_hi).  On Grumpkin G1, over BN254 Fq.  Everything of size
2^k stays on the PCS's device: the basis is derived there in one batch
(``hash_to_curve_batch``), the L/R commitments go through K1 + K2 on
Grumpkin, the base fold through the IPA fold kernel (``kernels/ipa.py``),
and the field folds and the verifier's h(X) are tensor passes.
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..curves import device as cdev
from ..curves.host import AffinePoint
from ..curves.msm import msm_affine, variable_base_msm
from ..curves.specs import GRUMPKIN_G1, CurveSpec, sqrt_mod
from ..fields import limb
from ..fields.host import Fp, batch_invert
from ..fields.spec import FieldSpec
from ..kernels import ipa as kipa
from ..ops.keccak_batch import keccak256_many
from ..poly.multilinear import MLPoly, eq_xy
from ..utils.keccak import keccak256
from . import additive

SETUP_TAG = b"MultilinearIpa::setup"


def hash_to_curve(curve: CurveSpec, tag: bytes, idx: int) -> AffinePoint:
    """Deterministic try-and-increment point derivation (replaces
    halo2_curves' hash_to_curve; SRS bit-compat is out of scope)."""
    base = curve.base
    ctr = 0
    while True:
        digest = keccak256(tag + idx.to_bytes(4, "little") + ctr.to_bytes(4, "little"))
        x = int.from_bytes(digest, "little") % base.p
        rhs = (pow(x, 3, base.p) + curve.b) % base.p
        if pow(rhs, (base.p - 1) // 2, base.p) in (0, 1):
            y = sqrt_mod(rhs, base.p)
            # deterministic sign choice
            if y % 2 == 1:
                y = base.p - y
            return AffinePoint(curve, Fp(x, base), Fp(y, base))
        ctr += 1


def _sqrt_candidates(spec: FieldSpec, a: torch.Tensor):
    """(y, ok) for Montgomery a [n, 8]: ok where a is a square (or 0), and then
    y^2 = a.  Tonelli-Shanks with a fixed number of steps (every element
    takes the same squarings), so the whole batch is a few hundred
    products; a non-square gives some y with y^2 != a."""
    p = spec.p
    s = ((p - 1) & -(p - 1)).bit_length() - 1
    q = (p - 1) >> s
    c = limb._consts(spec, a.device)
    nonres = next(z for z in range(2, 1000) if pow(z, (p - 1) // 2, p) == p - 1)
    z = pow(nonres, q, p)  # a root of unity of order 2^s
    d = limb.unpack(a)
    w = limb.unpack(limb.pow_const(spec, a, (q - 1) // 2))
    x = limb.d_mul(d, w, c)  # a^((q + 1) / 2)
    b = limb.d_mul(x, w, c)  # a^q
    one = c["one"]
    for k in range(s, 1, -1):
        b2k = b
        for _ in range(k - 2):
            b2k = limb.d_mul(b2k, b2k, c)
        flip = ~(b2k == one).all(dim=0)
        x = torch.where(flip, limb.d_mul(x, limb.d_const(spec, z, a.device), c), x)
        b = torch.where(flip, limb.d_mul(b, limb.d_const(spec, z * z % p, a.device), c), b)
        z = z * z % p
    ok = (limb.d_mul(x, x, c) == d).all(dim=0)
    return limb.pack(x), ok


def hash_to_curve_batch(curve: CurveSpec, tag: bytes, n: int, device,
                        tries: int | None = None) -> torch.Tensor:
    """The points hash_to_curve(curve, tag, i) for i < n, as affine
    ``int32[n, 2, 8]`` on `device`: the same digests, tries and sign choice.

    Every index takes `tries` consecutive counters (by default 2 to 16, so
    that a batch holds about 2^21 digests) in one batch of native Keccak and
    one batch of square roots on the device; an index keeps its first
    counter that gives a point, and an index with none takes the next
    `tries` counters."""
    base = curve.base
    if tries is None:
        tries = max(2, min(16, (1 << 21) // max(1, n)))
    x_out = limb.zeros((n,), device)
    y_out = limb.zeros((n,), device)
    todo = np.arange(n)
    ctr0 = 0
    b_mont = limb.const(base, curve.b, device)
    while todo.size:
        msgs = [tag + int(i).to_bytes(4, "little") + (ctr0 + t).to_bytes(4, "little")
                for i in todo for t in range(tries)]
        blob = b"".join(keccak256_many(msgs))
        raw = torch.from_numpy(np.frombuffer(blob, dtype="<i4").reshape(-1, 8).copy()).to(device)
        x = limb.to_mont(base, raw)  # the digest mod p: CIOS takes any value below 2^256
        rhs = limb.add(base, limb.mont_mul(base, limb.mont_mul(base, x, x), x), b_mont)
        y, ok = _sqrt_candidates(base, rhs)
        ok = ok.reshape(-1, tries)
        found = ok.any(dim=1)
        first = ok.to(torch.int8).argmax(dim=1)  # the first counter that gives a point
        pick = torch.arange(todo.size, device=device) * tries + first
        idx = torch.from_numpy(todo).to(device)[found]
        x_out[idx] = x[pick][found]
        y_out[idx] = y[pick][found]
        todo = todo[~found.cpu().numpy()]
        ctr0 += tries
    # the sign choice: y with an even canonical representative
    odd = (limb.from_mont(base, y_out)[:, 0] & 1).bool()
    y_out = torch.where(odd.unsqueeze(1), limb.neg(base, y_out), y_out)
    return torch.stack([x_out, y_out], dim=1)


class IpaParams:
    def __init__(self, curve, num_vars: int, g: torch.Tensor, h: AffinePoint):
        self.curve = curve
        self.num_vars = num_vars
        self.g = g  # affine [2^k, 2, 8] on the PCS's device
        self.h = h


@functools.lru_cache(maxsize=4)
def _basis(curve: CurveSpec, n: int, device: torch.device) -> torch.Tensor:
    """The setup's basis of n points (deterministic; kept for the process)."""
    return hash_to_curve_batch(curve, SETUP_TAG, n, device)


class MultilinearIpa:
    def __init__(self, curve: CurveSpec = GRUMPKIN_G1, device=None):
        self.curve = curve
        self.field_spec = curve.scalar
        self.device = resolve_device(device)

    def setup(self, poly_size: int, batch_size: int, rng=None) -> IpaParams:
        assert poly_size & (poly_size - 1) == 0
        num_vars = poly_size.bit_length() - 1
        g = _basis(self.curve, poly_size, self.device)
        h = hash_to_curve(self.curve, b"MultilinearIpa::setup::h", 0)
        return IpaParams(self.curve, num_vars, g, h)

    def trim(self, param: IpaParams, poly_size: int, batch_size: int):
        num_vars = poly_size.bit_length() - 1
        if param.num_vars < num_vars:
            raise ValueError("SRS too small")
        pp = IpaParams(self.curve, num_vars, param.g[:poly_size], param.h)
        return pp, pp

    def dummy_commitment(self):
        return AffinePoint.identity(self.curve)

    def commit(self, pp: IpaParams, poly: MLPoly) -> AffinePoint:
        return variable_base_msm(
            self.curve, limb.from_mont(self.field_spec, poly.evals), pp.g
        )

    def batch_commit(self, pp, polys):
        return [self.commit(pp, p) for p in polys]

    def commit_and_write(self, pp, poly, transcript):
        comm = self.commit(pp, poly)
        transcript.write_point(comm)
        return comm

    def batch_commit_and_write(self, pp, polys, transcript):
        comms = self.batch_commit(pp, polys)
        for c in comms:
            transcript.write_point(c)
        return comms

    def read_commitments(self, vp, n, transcript):
        return [transcript.read_point(self.curve) for _ in range(n)]

    def combine_commitments(self, vp, scalars, bases):
        return msm_affine(scalars, bases)

    # ------------------------------------------------------------------- open
    def open(self, pp: IpaParams, poly: MLPoly, comm, point: Sequence[Fp],
             eval_, transcript):
        spec = self.field_spec
        dev = poly.device
        xi_0 = transcript.squeeze_challenge()
        h_prime = pp.h.scalar_mul(int(xi_0))

        bases = pp.g
        coeffs = poly.evals
        zs = eq_xy(spec, list(point), dev).evals

        for i in range(pp.num_vars):
            mid = 1 << (pp.num_vars - i - 1)
            bases_l, bases_r = bases[:mid], bases[mid:]
            coeffs_l, coeffs_r = coeffs[:mid], coeffs[mid:]
            zs_l, zs_r = zs[:mid], zs[mid:]

            c_l = limb.sum_reduce(spec, limb.mont_mul(spec, coeffs_r, zs_l))
            c_r = limb.sum_reduce(spec, limb.mont_mul(spec, coeffs_l, zs_r))
            c_l_fp, c_r_fp = (Fp(v, spec) for v in
                              limb.to_canonical_ints(spec, torch.stack([c_l, c_r])))

            l_i = variable_base_msm(
                self.curve, limb.from_mont(spec, coeffs_r), bases_l
            ) + h_prime.scalar_mul(int(c_l_fp))
            r_i = variable_base_msm(
                self.curve, limb.from_mont(spec, coeffs_l), bases_r
            ) + h_prime.scalar_mul(int(c_r_fp))
            transcript.write_point(l_i)
            transcript.write_point(r_i)

            xi = transcript.squeeze_challenge()
            xi_inv = xi.inv()

            bases = kipa.base_fold(self.curve, bases_l, bases_r, int(xi))
            coeffs = limb.add(
                spec, coeffs_l, limb.mont_mul(spec, coeffs_r, limb.const(spec, int(xi_inv), dev))
            )
            zs = limb.add(
                spec, zs_l, limb.mont_mul(spec, zs_r, limb.const(spec, int(xi), dev))
            )

        g_k = cdev.affine_to_host(self.curve, bases[:1])[0]
        transcript.write_point(g_k)
        c = Fp(limb.to_canonical_ints(spec, coeffs[:1])[0], spec)
        transcript.write_field_element(c)

    def batch_open(self, pp, polys, comms, points, evals, transcript):
        additive.batch_open(
            self, pp, pp.num_vars, polys, comms, points, evals, transcript
        )

    # ----------------------------------------------------------------- verify
    def verify(self, vp: IpaParams, comm: AffinePoint, point: Sequence[Fp],
               eval_: Fp, transcript):
        spec = self.field_spec
        xi_0 = transcript.squeeze_challenge()
        ls, rs, xis = [], [], []
        for _ in range(vp.num_vars):
            ls.append(transcript.read_point(self.curve))
            rs.append(transcript.read_point(self.curve))
            xis.append(transcript.squeeze_challenge())
        g_k = transcript.read_point(self.curve)
        c = transcript.read_field_element()

        xi_invs = batch_invert(list(xis))
        eval_prime = xi_0 * eval_
        c_k = msm_affine(
            xi_invs + xis + [eval_prime], ls + rs + [vp.h], vp.g.device
        ) + comm

        h_poly = MLPoly(spec, h_coeffs(spec, xis, vp.g.device))
        h_at_point = h_poly.evaluate(list(point))

        lhs_ok = c_k == msm_affine(
            [c, c * h_at_point * xi_0], [g_k, vp.h]
        )
        g_ok = g_k == variable_base_msm(
            self.curve, limb.from_mont(spec, h_poly.evals), vp.g
        )
        if not (lhs_ok and g_ok):
            raise ValueError("Invalid multilinear IPA open")

    def batch_verify(self, vp, comms, points, evals, transcript):
        additive.batch_verify(
            self, vp, vp.num_vars, comms, points, evals, transcript
        )


def h_coeffs(spec: FieldSpec, xis: List[Fp], device) -> torch.Tensor:
    """h(X) coefficients (ipa.rs:325-343) as a Montgomery [2^k, 8] tensor:
    the second half of each doubling is the first times the next ξ, the
    last ξ first."""
    assert xis
    c = limb._consts(spec, device)
    d = c["one"].clone()
    for xi in reversed(xis):
        d = torch.cat([d, limb.d_mul(d, limb.d_const(spec, int(xi), device), c)], dim=1)
    return limb.pack(d)
