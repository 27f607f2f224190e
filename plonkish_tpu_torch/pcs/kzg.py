"""Multilinear KZG (PST13-style) over BN254 (port of plonkish_tpu/pcs/kzg.py).

- SRS: eq-basis G1 tables for every prefix size (eqs[i] commits
  eq(s_0..s_{i-1}, .)) plus s_i * G2.  The tables live on the PCS's device as
  affine ``int32[2^i, 2, 8]``: normalised once at setup, the form the MSM
  kernel reads (the reference caches the same normalisation on its prover
  params, kzg.py:89-108).
- commit = variable-base MSM of the canonical evaluations against eqs[k].
- open = multilinear quotients, each committed by MSM; verify = pairing
  product on the host.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Sequence

import torch

from .. import config, resolve_device
from ..curves.host import AffinePoint
from ..curves.msm import fixed_base_msm, msm_affine, variable_base_msm
from ..curves.pairing import G2Point, pairings_product_is_identity
from ..curves.specs import BN254_G1, CurveSpec
from ..fields import limb
from ..fields.host import Fp
from ..poly.multilinear import MLPoly
from ..utils.transcript import Keccak256Transcript
from . import additive


@dataclasses.dataclass
class MultilinearKzgParams:
    g1: AffinePoint
    eqs: List[torch.Tensor]  # eqs[i]: affine [2^i, 2, 8]
    g2: G2Point
    ss: List[G2Point]

    @property
    def num_vars(self) -> int:
        return len(self.eqs) - 1


@dataclasses.dataclass
class MultilinearKzgProverParams:
    g1: AffinePoint
    eqs: List[torch.Tensor]

    @property
    def num_vars(self) -> int:
        return len(self.eqs) - 1

    def eq(self, num_vars: int) -> torch.Tensor:
        return self.eqs[num_vars]


@dataclasses.dataclass
class MultilinearKzgVerifierParams:
    g1: AffinePoint
    g2: G2Point
    ss: List[G2Point]

    @property
    def num_vars(self) -> int:
        return len(self.ss)


class MultilinearKzg:
    def __init__(self, curve: CurveSpec = BN254_G1, device=None):
        self.curve = curve
        self.field_spec = curve.scalar
        self.device = resolve_device(device)

    # ------------------------------------------------------------- lifecycle
    def setup(self, poly_size: int, batch_size: int, rng: random.Random):
        assert poly_size & (poly_size - 1) == 0
        num_vars = poly_size.bit_length() - 1
        spec = self.field_spec
        dev = self.device
        ss = [Fp(rng.randrange(1, spec.p), spec) for _ in range(num_vars)]

        g1 = AffinePoint.generator(self.curve)
        # eq tables per prefix (kzg.rs:174-195): level i over s_0..s_{i-1},
        # index bit i <-> s_i
        c = limb._consts(spec, dev)
        level = c["one"].clone()
        levels = [level]
        for s_i in ss:
            hi = limb.d_mul(level, limb.d_const(spec, int(s_i), dev), c)
            lo = limb.d_sub(level, hi, c)
            level = torch.cat([lo, hi], dim=1)
            levels.append(level)
        scalars = limb.pack(torch.cat(levels, dim=1))
        points = fixed_base_msm(self.curve, g1, scalars)
        eqs = list(torch.split(points, [1 << i for i in range(num_vars + 1)]))
        eqs = [e.contiguous() for e in eqs]

        g2 = G2Point.generator()
        ss_g2 = [g2.scalar_mul(int(s)) for s in ss]
        return MultilinearKzgParams(g1=g1, eqs=eqs, g2=g2, ss=ss_g2)

    def trim(self, param: MultilinearKzgParams, poly_size: int, batch_size: int):
        num_vars = poly_size.bit_length() - 1
        if param.num_vars < num_vars:
            raise ValueError("SRS too small")
        pp = MultilinearKzgProverParams(g1=param.g1, eqs=param.eqs[: num_vars + 1])
        vp = MultilinearKzgVerifierParams(
            g1=param.g1, g2=param.g2, ss=param.ss[:num_vars]
        )
        return pp, vp

    def dummy_commitment(self):
        return AffinePoint.identity(self.curve)

    # ----------------------------------------------------------------- commit
    def commit(self, pp: MultilinearKzgProverParams, poly: MLPoly) -> AffinePoint:
        scalars = limb.from_mont(self.field_spec, poly.evals)
        return variable_base_msm(self.curve, scalars, pp.eq(poly.num_vars))

    def batch_commit(self, pp, polys):
        return [self.commit(pp, p) for p in polys]

    def commit_and_write(self, pp, poly, transcript: Keccak256Transcript):
        comm = self.commit(pp, poly)
        transcript.write_point(comm)
        return comm

    def batch_commit_and_write(self, pp, polys, transcript):
        comms = self.batch_commit(pp, polys)
        for c in comms:
            transcript.write_point(c)
        return comms

    def read_commitments(self, vp, n, transcript) -> List[AffinePoint]:
        return [transcript.read_point(self.curve) for _ in range(n)]

    def combine_commitments(self, vp, scalars, bases) -> AffinePoint:
        return msm_affine(scalars, bases)

    # ------------------------------------------------------------------- open
    def open(
        self,
        pp: MultilinearKzgProverParams,
        poly: MLPoly,
        comm,
        point: Sequence[Fp],
        eval_,
        transcript: Keccak256Transcript,
    ) -> None:
        """Multilinear quotients (pcs/multilinear.rs:72-107) + per-variable
        commitments (kzg.rs:291-301)."""
        spec = self.field_spec
        num_vars = poly.num_vars
        assert len(point) == num_vars
        if config.sanity_checks():
            # reference `sanity-check` feature (kzg.rs:286-296): the claimed
            # commitment and evaluation must match the polynomial.  The
            # additive batch open claims neither (comm and eval_ None); the
            # JAX package compares its None eval and so refuses every
            # batch open under the flag.
            if comm is not None and self.commit(pp, poly) != comm:
                raise AssertionError("sanity: kzg open comm mismatch")
            if eval_ is not None and poly.evaluate(list(point)) != eval_:
                raise AssertionError("sanity: kzg open eval mismatch")
        c = limb._consts(spec, poly.device)
        remainder = limb.unpack(poly.evals)
        quotient_comms: List[AffinePoint] = []  # var k-1 first
        for var in range(num_vars - 1, -1, -1):
            half = 1 << var
            lo, hi = remainder[:, :half], remainder[:, half:]
            quotient = limb.d_sub(hi, lo, c)
            x_i = limb.d_const(spec, int(point[var]), poly.device)
            remainder = limb.d_add(limb.d_mul(quotient, x_i, c), lo, c)
            q_canon = limb.pack(limb.d_mul(quotient, c["raw1"], c))
            quotient_comms.append(
                variable_base_msm(self.curve, q_canon, pp.eq(var))
            )
        quotient_comms.reverse()  # write variable 0 first
        for q in quotient_comms:
            transcript.write_point(q)

    def batch_open(self, pp, polys, comms, points, evals, transcript):
        additive.batch_open(
            self, pp, pp.num_vars, polys, comms, points, evals, transcript
        )

    # ----------------------------------------------------------------- verify
    def verify(
        self,
        vp: MultilinearKzgVerifierParams,
        comm: AffinePoint,
        point: Sequence[Fp],
        eval_: Fp,
        transcript: Keccak256Transcript,
    ) -> None:
        """Pairing check e(C - eval*g1, -g2) * prod e(q_i, (s_i - x_i)*g2) == 1
        (kzg.rs:330-361)."""
        quotients = [transcript.read_point(self.curve) for _ in range(len(point))]
        neg_g2 = -vp.g2
        rhs = [neg_g2] + [
            vp.ss[i] + (-(vp.g2.scalar_mul(int(point[i]))))
            for i in range(len(point))
        ]
        lhs = [comm + (-(vp.g1.scalar_mul(int(eval_))))] + quotients
        if not pairings_product_is_identity(list(zip(lhs, rhs))):
            raise ValueError("Invalid multilinear KZG open")

    def batch_verify(self, vp, comms, points, evals, transcript):
        additive.batch_verify(
            self, vp, vp.num_vars, comms, points, evals, transcript
        )
