"""Zeromorph: multilinear PCS via univariate KZG degree-check (eprint 2023/917;
port of plonkish_tpu/pcs/zeromorph.py).

Mirrors plonkish_backend/src/pcs/multilinear/zeromorph.rs:
multilinear quotients committed as univariate polys, q_hat = Σ y^i X^{2^n-2^i} q_i,
single shifted-SRS degree-check opening at x with the
eval_and_quotient_scalars recombination (zeromorph.rs:263-299).  The
quotients, q_hat and the opened polynomial stay on the device.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Sequence

import torch

from ..curves.host import AffinePoint
from ..curves.msm import msm_affine, variable_base_msm
from ..curves.pairing import G2Point, pairings_product_is_identity
from ..curves.specs import BN254_G1, CurveSpec
from ..fields import limb
from ..fields.host import Fp, batch_invert
from ..fields.spec import FieldSpec
from ..poly.multilinear import MLPoly
from ..poly.univariate import DUniPoly
from . import additive
from .univariate_kzg import (
    UnivariateKzg,
    UnivariateKzgProverParam,
    UnivariateKzgVerifierParam,
)


@dataclasses.dataclass
class ZeromorphProverParam:
    commit_pp: UnivariateKzgProverParam
    open_pp: UnivariateKzgProverParam

    @property
    def degree(self):
        return self.commit_pp.degree


@dataclasses.dataclass
class ZeromorphVerifierParam:
    vp: UnivariateKzgVerifierParam
    s_offset_g2: G2Point


def multilinear_quotients(spec: FieldSpec, poly: MLPoly, point: Sequence[Fp]):
    """Per-variable quotients + remainder (pcs/multilinear.rs:72-107).

    Returns (quotient tensors ordered by variable index ascending —
    quotient[i] has 2^i entries — and the remainder evaluation)."""
    remainder = poly.evals
    quotients: List = [None] * len(point)
    for var in range(len(point) - 1, -1, -1):
        half = 1 << var
        lo, hi = remainder[:half], remainder[half:]
        quotients[var] = limb.sub(spec, hi, lo)
        x_i = limb.const(spec, int(point[var]), poly.device)
        remainder = limb.add(spec, limb.mont_mul(spec, quotients[var], x_i), lo)
    rem = Fp(limb.to_canonical_ints(spec, remainder)[0], spec)
    return quotients, rem


class Zeromorph:
    def __init__(self, curve: CurveSpec = BN254_G1, device=None):
        self.curve = curve
        self.field_spec = curve.scalar
        self.kzg = UnivariateKzg(curve, device)
        self.device = self.kzg.device

    def setup(self, poly_size, batch_size, rng: random.Random):
        return self.kzg.setup(poly_size, batch_size, rng)

    def trim(self, param, poly_size, batch_size):
        commit_pp, vp = self.kzg.trim(param, poly_size, batch_size)
        offset = param.powers_of_s_g1.shape[0] - poly_size
        open_pp = UnivariateKzgProverParam(
            g1=param.g1, powers_of_s_g1=param.powers_of_s_g1[offset:]
        )
        # s^offset on G2 for the degree check
        s_offset_g2 = param.s_offset_g2(offset)
        return (
            ZeromorphProverParam(commit_pp=commit_pp, open_pp=open_pp),
            ZeromorphVerifierParam(vp=vp, s_offset_g2=s_offset_g2),
        )

    def dummy_commitment(self):
        return AffinePoint.identity(self.curve)

    def _commit_tensor(self, pp: ZeromorphProverParam, tensor) -> AffinePoint:
        return variable_base_msm(
            self.curve, limb.from_mont(self.field_spec, tensor),
            pp.commit_pp.basis(tensor.shape[0]),
        )

    def commit(self, pp: ZeromorphProverParam, poly: MLPoly) -> AffinePoint:
        return self._commit_tensor(pp, poly.evals)

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
    def open(self, pp: ZeromorphProverParam, poly: MLPoly, comm,
             point: Sequence[Fp], eval_, transcript):
        spec = self.field_spec
        dev = poly.device
        num_vars = len(point)
        quotients, remainder = multilinear_quotients(spec, poly, point)
        if eval_ is None:
            eval_ = remainder
        for q in quotients:
            transcript.write_point(self._commit_tensor(pp, q))

        y = transcript.squeeze_challenge()

        # q_hat = Σ y^i · X^{2^n - 2^i} · q_i  (zeromorph.rs:156-166)
        n = 1 << num_vars
        q_hat = limb.zeros((n,), dev)
        y_pow = Fp.one(spec)
        for idx, q in enumerate(quotients):
            offset = n - (1 << idx)
            scaled = limb.mont_mul(spec, q, limb.const(spec, int(y_pow), dev))
            q_hat = torch.cat([q_hat[:offset], limb.add(spec, q_hat[offset:], scaled)], dim=0)
            y_pow = y_pow * y
        transcript.write_point(self._commit_tensor(pp, q_hat))

        x = transcript.squeeze_challenge()
        z = transcript.squeeze_challenge()

        eval_scalar, q_scalars = _eval_and_quotient_scalars(
            spec, y, x, z, list(point)
        )

        # f = z·poly + q_hat + eval_scalar·eval at coeff 0 + Σ scalar_i·q_i
        f = limb.add(spec, limb.mont_mul(spec, poly.evals, limb.const(spec, int(z), dev)), q_hat)
        f0 = limb.add(spec, f[:1], limb.const(spec, int(eval_scalar * eval_), dev)[None])
        f = torch.cat([f0, f[1:]], dim=0)
        for q, scalar in zip(quotients, q_scalars):
            sz = q.shape[0]
            head = limb.add(spec, f[:sz], limb.mont_mul(spec, q, limb.const(spec, int(scalar), dev)))
            f = torch.cat([head, f[sz:]], dim=0)

        # degree-check opening against the shifted SRS at x with eval 0
        self.kzg.open(pp.open_pp, DUniPoly(spec, f), None, x, Fp.zero(spec), transcript)

    def batch_open(self, pp, polys, comms, points, evals, transcript):
        num_vars = len(points[0]) if points else 0
        additive.batch_open(
            self, pp, num_vars, polys, comms, points, evals, transcript
        )

    # ----------------------------------------------------------------- verify
    def verify(self, vp: ZeromorphVerifierParam, comm: AffinePoint,
               point: Sequence[Fp], eval_: Fp, transcript):
        spec = self.field_spec
        num_vars = len(point)
        q_comms = [transcript.read_point(self.curve) for _ in range(num_vars)]
        y = transcript.squeeze_challenge()
        q_hat_comm = transcript.read_point(self.curve)
        x = transcript.squeeze_challenge()
        z = transcript.squeeze_challenge()

        eval_scalar, q_scalars = _eval_and_quotient_scalars(
            spec, y, x, z, list(point)
        )
        scalars = [Fp.one(spec), z, eval_scalar * eval_] + q_scalars
        bases = [q_hat_comm, comm, vp.vp.g1] + q_comms
        c = msm_affine(scalars, bases)

        pi = transcript.read_point(self.curve)
        rhs2 = vp.vp.s_g2 + (-(vp.vp.g2.scalar_mul(int(x))))
        if not pairings_product_is_identity(
            [(c, -vp.s_offset_g2), (pi, rhs2)]
        ):
            raise ValueError("Invalid Zeromorph KZG open")

    def batch_verify(self, vp, comms, points, evals, transcript):
        num_vars = len(points[0]) if points else 0
        additive.batch_verify(
            self, vp, num_vars, comms, points, evals, transcript
        )


def _eval_and_quotient_scalars(spec, y: Fp, x: Fp, z: Fp, u: List[Fp]):
    """zeromorph.rs:263-299."""
    num_vars = len(u)
    squares_of_x = []
    sq = x
    for _ in range(num_vars + 1):
        squares_of_x.append(sq)
        sq = sq * sq
    # offsets_of_x[i] = Π_{j>i} x^{2^j}... built by reverse scan skipping last
    offsets = []
    state = Fp.one(spec)
    for power in reversed(squares_of_x[:-1]):
        state = state * power
        offsets.append(state)
    offsets.reverse()
    v_numer = squares_of_x[num_vars] - Fp.one(spec)
    v_denoms = batch_invert([s - Fp.one(spec) for s in squares_of_x])
    vs = [v_numer * d for d in v_denoms]
    q_scalars = []
    y_pow = Fp.one(spec)
    for offset_of_x, square_of_x, v_i, v_j, u_i in zip(
        offsets, squares_of_x, vs, vs[1:], u
    ):
        q_scalars.append(
            -(y_pow * offset_of_x + z * (square_of_x * v_j - u_i * v_i))
        )
        y_pow = y_pow * y
    return -vs[0] * z, q_scalars
