"""Gemini: multilinear PCS via univariate KZG (eprint 2022/420 §2.4.2; port of
plonkish_tpu/pcs/gemini.py).

Mirrors plonkish_backend/src/pcs/multilinear/gemini.rs: the
multilinear poly's evals are committed as univariate coefficients; opening
folds a chain f_{i+1} = fold(f_i, x_i) on the device, commits each fold,
evaluates the chain at beta / -beta^{2^i}, and defers to the univariate KZG
batched opening.  The chain stays on the device as `DUniPoly`s (the
reference's host `UniPoly`s hold the same coefficients).  The verifier
recovers eval_0 by the 3-term recurrence (gemini.rs:184-190).
"""

from __future__ import annotations

import random
from typing import Sequence

from ..backend.pcs_api import Evaluation
from ..curves.host import AffinePoint
from ..curves.msm import msm_affine, variable_base_msm
from ..curves.specs import BN254_G1, CurveSpec
from ..fields import limb
from ..fields.host import Fp
from ..poly.multilinear import MLPoly
from ..poly.univariate import DUniPoly
from . import additive
from .univariate_kzg import UnivariateKzg


class Gemini:
    def __init__(self, curve: CurveSpec = BN254_G1, device=None):
        self.curve = curve
        self.field_spec = curve.scalar
        self.kzg = UnivariateKzg(curve, device)
        self.device = self.kzg.device

    # lifecycle delegates to univariate KZG
    def setup(self, poly_size, batch_size, rng: random.Random):
        return self.kzg.setup(poly_size, batch_size, rng)

    def trim(self, param, poly_size, batch_size):
        return self.kzg.trim(param, poly_size, batch_size)

    def dummy_commitment(self):
        return AffinePoint.identity(self.curve)

    # commit = univariate commit over evals-as-coeffs
    def commit(self, pp, poly: MLPoly) -> AffinePoint:
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
    def open(self, pp, poly: MLPoly, comm, point: Sequence[Fp], eval_, transcript):
        spec = self.field_spec
        num_vars = len(point)
        # fold chain (gemini.rs:100-120)
        fs_dev = [poly.evals]
        for x_i in point[: num_vars - 1]:
            fs_dev.append(limb.fold_pairs(spec, fs_dev[-1], limb.const(spec, int(x_i), poly.device)))
        fs = [DUniPoly(spec, t) for t in fs_dev]
        for t in fs_dev[1:]:
            transcript.write_point(self._commit_tensor(pp, t))

        beta = transcript.squeeze_challenge()
        points = [beta]
        sq = beta
        for _ in range(num_vars):
            points.append(-sq)
            sq = sq * sq

        index_pairs = [(0, 0), (0, 1)] + [(i, i + 1) for i in range(1, num_vars)]
        evals = [
            Evaluation(idx, pt, fs[idx].evaluate(points[pt]))
            for (idx, pt) in index_pairs
        ]
        transcript.write_field_elements([e.value for e in evals[1:]])

        # comms list unused by the univariate batch_open prover path
        self.kzg.batch_open(pp, fs, None, points, evals, transcript)

    def _commit_tensor(self, pp, tensor) -> AffinePoint:
        return variable_base_msm(
            self.curve, limb.from_mont(self.field_spec, tensor), pp.basis(tensor.shape[0])
        )

    def batch_open(self, pp, polys, comms, points, evals, transcript):
        num_vars = len(points[0]) if points else 0
        additive.batch_open(
            self, pp, num_vars, polys, comms, points, evals, transcript
        )

    # ----------------------------------------------------------------- verify
    def verify(self, vp, comm: AffinePoint, point: Sequence[Fp], eval_: Fp,
               transcript):
        spec = self.field_spec
        num_vars = len(point)
        comms = [comm] + [
            transcript.read_point(self.curve) for _ in range(num_vars - 1)
        ]
        beta = transcript.squeeze_challenge()
        squares_of_beta = []
        sq = beta
        for _ in range(num_vars):
            squares_of_beta.append(sq)
            sq = sq * sq

        neg_evals = transcript.read_field_elements(num_vars)

        one = Fp.one(spec)
        two = Fp(2, spec)
        eval_pos = eval_
        for eval_neg, sq_beta, x_i in reversed(
            list(zip(neg_evals, squares_of_beta, point))
        ):
            denom = ((one - x_i) * sq_beta + x_i).inv()
            eval_pos = (
                two * sq_beta * eval_pos
                - ((one - x_i) * sq_beta - x_i) * eval_neg
            ) * denom
        eval_0 = eval_pos

        index_pairs = [(0, 0), (0, 1)] + [(i, i + 1) for i in range(1, num_vars)]
        all_evals = [eval_0] + neg_evals
        evals = [
            Evaluation(idx, pt, v)
            for (idx, pt), v in zip(index_pairs, all_evals)
        ]
        points = [beta] + [-s for s in squares_of_beta]
        self.kzg.batch_verify(vp, comms, points, evals, transcript)

    def batch_verify(self, vp, comms, points, evals, transcript):
        num_vars = len(points[0]) if points else 0
        additive.batch_verify(
            self, vp, num_vars, comms, points, evals, transcript
        )
