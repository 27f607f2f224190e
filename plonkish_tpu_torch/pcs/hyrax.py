"""Multilinear Hyrax: matrix commitment over the IPA basis (port of
plonkish_tpu/pcs/hyrax.py).

Mirrors plonkish_backend/src/pcs/multilinear/hyrax.rs: split k
into row/col halves (row_num_vars = ceil(batch_num_vars/2)); commit = one
IPA-basis MSM per row chunk; open = fix_last_vars(hi) then an IPA open on the
eq(hi)-combined row.  Each row's commitment is one MSM (K1 + K2 on
Grumpkin), as in the reference.
"""

from __future__ import annotations

from typing import List, Sequence

from ..curves.host import AffinePoint
from ..curves.msm import msm_affine, variable_base_msm
from ..curves.specs import GRUMPKIN_G1, CurveSpec
from ..fields import limb
from ..fields.host import Fp
from ..poly.multilinear import MLPoly, eq_xy
from . import additive
from .ipa import IpaParams, MultilinearIpa


class HyraxParams:
    def __init__(self, curve, num_vars, batch_num_vars, row_num_vars,
                 ipa: IpaParams):
        self.curve = curve
        self.num_vars = num_vars
        self.batch_num_vars = batch_num_vars
        self.row_num_vars = row_num_vars
        self.ipa = ipa

    @property
    def row_len(self):
        return 1 << self.row_num_vars

    @property
    def num_chunks(self):
        return 1 << (self.num_vars - self.row_num_vars)


class MultilinearHyrax:
    def __init__(self, curve: CurveSpec = GRUMPKIN_G1, device=None):
        self.curve = curve
        self.field_spec = curve.scalar
        self._ipa = MultilinearIpa(curve, device)
        self.device = self._ipa.device

    def setup(self, poly_size: int, batch_size: int, rng=None) -> HyraxParams:
        assert poly_size & (poly_size - 1) == 0
        assert 0 < batch_size <= poly_size
        num_vars = poly_size.bit_length() - 1
        batch_num_vars = (poly_size * batch_size - 1).bit_length()
        row_num_vars = -(-batch_num_vars // 2)
        ipa = self._ipa.setup(1 << row_num_vars, 0)
        return HyraxParams(self.curve, num_vars, batch_num_vars, row_num_vars, ipa)

    def trim(self, param: HyraxParams, poly_size: int, batch_size: int):
        num_vars = poly_size.bit_length() - 1
        batch_num_vars = (poly_size * batch_size - 1).bit_length()
        row_num_vars = -(-batch_num_vars // 2)
        if param.row_num_vars < row_num_vars:
            raise ValueError("SRS too small")
        ipa_pp, _ = self._ipa.trim(param.ipa, 1 << row_num_vars, 0)
        pp = HyraxParams(self.curve, num_vars, batch_num_vars, row_num_vars, ipa_pp)
        return pp, pp

    def dummy_commitment(self):
        return []

    # ----------------------------------------------------------------- commit
    def commit(self, pp: HyraxParams, poly: MLPoly) -> List[AffinePoint]:
        spec = self.field_spec
        scalars = limb.from_mont(spec, poly.evals)
        return [
            variable_base_msm(
                self.curve,
                scalars[i * pp.row_len: (i + 1) * pp.row_len],
                pp.ipa.g,
            )
            for i in range(pp.num_chunks)
        ]

    def batch_commit(self, pp, polys):
        return [self.commit(pp, p) for p in polys]

    def commit_and_write(self, pp, poly, transcript):
        comm = self.commit(pp, poly)
        for pt in comm:
            transcript.write_point(pt)
        return comm

    def batch_commit_and_write(self, pp, polys, transcript):
        comms = self.batch_commit(pp, polys)
        for comm in comms:
            for pt in comm:
                transcript.write_point(pt)
        return comms

    def read_commitments(self, vp: HyraxParams, n, transcript):
        return [
            [transcript.read_point(self.curve) for _ in range(vp.num_chunks)]
            for _ in range(n)
        ]

    def combine_commitments(self, vp: HyraxParams, scalars, bases):
        """Per-chunk MSM (hyrax.rs:80-107); empty (dummy) comms are skipped."""
        pairs = [(s, b) for s, b in zip(scalars, bases) if b]
        num_chunks = len(pairs[0][1])
        out = []
        for idx in range(num_chunks):
            out.append(
                msm_affine([s for s, _ in pairs], [b[idx] for _, b in pairs])
            )
        return out

    # ------------------------------------------------------------------- open
    def open(self, pp: HyraxParams, poly: MLPoly, comm, point: Sequence[Fp],
             eval_, transcript: Keccak256Transcript):
        lo, hi = list(point[: pp.row_num_vars]), list(point[pp.row_num_vars:])
        row_poly = poly.fix_last_vars(hi) if hi else poly
        self._ipa.open(pp.ipa, row_poly, None, lo, eval_, transcript)

    def batch_open(self, pp, polys, comms, points, evals, transcript):
        additive.batch_open(
            self, pp, pp.num_vars, polys, comms, points, evals, transcript
        )

    # ----------------------------------------------------------------- verify
    def verify(self, vp: HyraxParams, comm: List[AffinePoint],
               point: Sequence[Fp], eval_: Fp, transcript):
        assert len(comm) == vp.num_chunks
        spec = self.field_spec
        lo, hi = list(point[: vp.row_num_vars]), list(point[vp.row_num_vars:])
        if hi:
            scalars = eq_xy(spec, hi, "cpu").to_fps()
            row_comm = msm_affine(scalars, comm, self.device)
        else:
            assert vp.num_chunks == 1
            row_comm = comm[0]
        self._ipa.verify(vp.ipa, row_comm, lo, eval_, transcript)

    def batch_verify(self, vp, comms, points, evals, transcript):
        additive.batch_verify(
            self, vp, vp.num_vars, comms, points, evals, transcript
        )
