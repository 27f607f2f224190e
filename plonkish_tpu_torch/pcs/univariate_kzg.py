# Ported from plonkish_tpu/pcs/univariate_kzg.py (the eval-set machinery is
# copied); imports resolve inside plonkish_tpu_torch.
"""Univariate KZG over BN254 (port of plonkish_tpu/pcs/univariate_kzg.py).

Mirrors plonkish_backend/src/pcs/univariate/kzg.rs: powers-of-s
SRS, MSM commit over coefficients, witness-quotient open, pairing verify, and
the fflonk-style same-point-set batched opening (eval_sets / set_scalars /
normalized recombination).  The SRS lives on the PCS's device as affine
``int32[n, 2, 8]`` (the form K1 reads); the provers of Gemini and Zeromorph
hand it `DUniPoly`s, so every O(n) step stays on the device.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence, Tuple

import torch

from .. import resolve_device
from ..backend.pcs_api import Evaluation
from ..curves.host import AffinePoint
from ..curves.msm import fixed_base_msm, msm_affine, variable_base_msm
from ..curves.pairing import G2Point, pairings_product_is_identity
from ..curves.specs import BN254_G1, CurveSpec
from ..fields import limb
from ..fields.host import Fp
from ..piop.sum_check import barycentric_interpolate, barycentric_weights
from ..poly.univariate import powers_tensor


@dataclasses.dataclass
class UnivariateKzgParam:
    powers_of_s_g1: torch.Tensor  # affine [n, 2, 8]
    g1: AffinePoint
    g2: G2Point
    s_g2: G2Point
    # s^offset·G2 for every trim offset n − 2^m (Zeromorph degree check,
    # kzg.rs:84-101 slices the reference's full G2 power table).  Computed at
    # setup so the trapdoor s is NOT retained in the param.
    offset_g2: Dict[int, G2Point] = dataclasses.field(default_factory=dict)

    @property
    def degree(self) -> int:
        return self.powers_of_s_g1.shape[0] - 1

    def s_offset_g2(self, offset: int) -> G2Point:
        if offset == 0:
            return self.g2
        if offset not in self.offset_g2:
            raise ValueError(
                f"SRS has no G2 power for offset {offset}; regenerate the "
                "setup with a size covering this trim"
            )
        return self.offset_g2[offset]


@dataclasses.dataclass
class UnivariateKzgProverParam:
    g1: AffinePoint
    powers_of_s_g1: torch.Tensor  # affine [n, 2, 8]

    @property
    def degree(self) -> int:
        return self.powers_of_s_g1.shape[0] - 1

    def basis(self, n: int) -> torch.Tensor:
        """The MSM basis of the first n powers."""
        return self.powers_of_s_g1[:n]


@dataclasses.dataclass
class UnivariateKzgVerifierParam:
    g1: AffinePoint
    g2: G2Point
    s_g2: G2Point


class UnivariateKzg:
    def __init__(self, curve: CurveSpec = BN254_G1, device=None):
        self.curve = curve
        self.field_spec = curve.scalar
        self.device = resolve_device(device)

    # ------------------------------------------------------------- lifecycle
    def setup(self, poly_size: int, batch_size: int, rng: random.Random):
        spec = self.field_spec
        s = Fp(rng.randrange(1, spec.p), spec)
        g1 = AffinePoint.generator(self.curve)
        powers_g1 = fixed_base_msm(
            self.curve, g1, powers_tensor(spec, s, poly_size, self.device))
        g2 = G2Point.generator()
        # Shifted G2 powers for every power-of-two trim (offset = n − 2^m);
        # computed while s is in scope so the param need not keep s.
        offset_g2 = {}
        m = 1
        while m <= poly_size:
            off = poly_size - m
            if off > 0:
                offset_g2[off] = g2.scalar_mul(pow(int(s), off, spec.p))
            m *= 2
        return UnivariateKzgParam(
            powers_of_s_g1=powers_g1, g1=g1, g2=g2,
            s_g2=g2.scalar_mul(int(s)), offset_g2=offset_g2,
        )

    def trim(self, param: UnivariateKzgParam, poly_size: int, batch_size: int):
        if param.powers_of_s_g1.shape[0] < poly_size:
            raise ValueError("SRS too small")
        pp = UnivariateKzgProverParam(
            g1=param.g1, powers_of_s_g1=param.powers_of_s_g1[:poly_size]
        )
        vp = UnivariateKzgVerifierParam(g1=param.g1, g2=param.g2, s_g2=param.s_g2)
        return pp, vp

    def dummy_commitment(self):
        return AffinePoint.identity(self.curve)

    # ----------------------------------------------------------------- commit
    def commit_coeffs(self, pp, coeffs) -> AffinePoint:
        """Commit a coefficient vector: host Fp list OR a Montgomery tensor
        [n, 8] on the device."""
        if isinstance(coeffs, (list, tuple)):
            if not coeffs:
                return AffinePoint.identity(self.curve)
            scalars = limb.from_ints([int(c) for c in coeffs], self.device)
        else:
            scalars = limb.from_mont(self.field_spec, coeffs)
        return variable_base_msm(self.curve, scalars, pp.basis(scalars.shape[0]))

    def commit(self, pp, poly) -> AffinePoint:
        assert pp.degree >= poly.degree()
        return self.commit_coeffs(pp, poly.coeffs)

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
    def open(self, pp, poly, comm, point: Fp, eval_, transcript):
        quotient = poly.div_by_roots([point])
        transcript.write_point(self.commit_coeffs(pp, quotient.coeffs))

    def batch_open(self, pp, polys, comms, points, evals, transcript):
        """fflonk-style batched opening (kzg.rs:301-354).

        `polys` may be host UniPoly or device DUniPoly — the O(n) algebra
        (β-combination, vanishing division, γ-combination, final witness
        quotient) runs wherever the polynomials live; DUniPoly keeps it on
        the device (the k=20 univariate prover spent hundreds of seconds
        doing this with host bigints)."""
        sets, superset = _eval_sets(evals)
        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()

        max_set_len = max(len(s.polys) for s in sets)
        powers_of_beta = _powers(beta, max_set_len)
        powers_of_gamma = _powers(gamma, len(sets))

        fs, qs = [], []
        for s in sets:
            f = None
            for b_pow, poly_idx in zip(powers_of_beta, s.polys):
                fi = polys[poly_idx].scale(b_pow)
                f = fi if f is None else f + fi
            q = f.div_by_roots([points[i] for i in s.points])
            fs.append(f)
            qs.append(q)
        q = None
        for g_pow, qi in zip(powers_of_gamma, qs):
            qi = qi.scale(g_pow)
            q = qi if q is None else q + qi

        self.commit_and_write(pp, q, transcript)
        z = transcript.squeeze_challenge()

        normalized_scalars, normalizer = _set_scalars(
            sets, powers_of_gamma, points, z
        )
        superset_eval = _vanishing_eval([points[i] for i in superset], z)
        q_scalar = -superset_eval * normalizer
        f = q.scale(q_scalar)
        for sc, fi in zip(normalized_scalars, fs):
            f = f + fi.scale(sc)
        self.open(pp, f, None, z, None, transcript)

    # ----------------------------------------------------------------- verify
    def verify(self, vp, comm: AffinePoint, point: Fp, eval_: Fp, transcript):
        pi = transcript.read_point(self.curve)
        c = pi.scalar_mul(int(point)) + comm + (
            -(vp.g1.scalar_mul(int(eval_)))
        )
        if not pairings_product_is_identity(
            [(c, -vp.g2), (pi, vp.s_g2)]
        ):
            raise ValueError("Invalid univariate KZG open")

    def batch_verify(self, vp, comms, points, evals, transcript):
        spec = self.field_spec
        sets, superset = _eval_sets(evals)
        beta = transcript.squeeze_challenge()
        gamma = transcript.squeeze_challenge()
        q_comm = transcript.read_point(self.curve)
        z = transcript.squeeze_challenge()

        max_set_len = max(len(s.polys) for s in sets)
        powers_of_beta = _powers(beta, max_set_len)
        powers_of_gamma = _powers(gamma, len(sets))
        normalized_scalars, normalizer = _set_scalars(
            sets, powers_of_gamma, points, z
        )
        scalars = _comm_scalars(
            len(list(comms)), sets, powers_of_beta, normalized_scalars
        )
        superset_eval = _vanishing_eval([points[i] for i in superset], z)
        q_scalar = -superset_eval * normalizer
        f_comm = msm_affine(
            scalars + [q_scalar], list(comms) + [q_comm]
        )
        eval_ = Fp.zero(spec)
        for sc, s in zip(normalized_scalars, sets):
            eval_ = eval_ + sc * s.r_eval(points, z, powers_of_beta)
        self.verify(vp, f_comm, z, eval_, transcript)


# ---------------------------------------------------------------------------
# eval-set machinery (kzg.rs:422-555)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _EvalSet:
    polys: List[int]
    points: List[int]
    diffs: List[int]
    evals: List[List[Fp]]

    def vanishing_diff_eval(self, points, z: Fp) -> Fp:
        acc = Fp.one(z.spec)
        for idx in self.diffs:
            acc = acc * (z - points[idx])
        return acc

    def r_eval(self, points, z: Fp, powers_of_beta) -> Fp:
        pts = [points[i] for i in self.points]
        weights = barycentric_weights(pts)
        acc = Fp.zero(z.spec)
        for b_pow, evals in zip(powers_of_beta, self.evals):
            acc = acc + b_pow * barycentric_interpolate(weights, pts, evals, z)
        return acc


def _eval_sets(evals: Sequence[Evaluation]):
    poly_shifts: List[Tuple[int, List[int], List[Fp]]] = []
    superset: List[int] = []
    for e in evals:
        entry = next((ps for ps in poly_shifts if ps[0] == e.poly), None)
        if entry is not None:
            _, pts, vals = entry
            if e.point not in pts:
                pts.append(e.point)
                vals.append(e.value)
        else:
            poly_shifts.append((e.poly, [e.point], [e.value]))
        if e.point not in superset:
            superset.append(e.point)
    superset = sorted(superset)

    sets: List[_EvalSet] = []
    for poly, pts, vals in poly_shifts:
        match = next(
            (s for s in sets if set(s.points) == set(pts)), None
        )
        if match is not None:
            if poly not in match.polys:
                match.polys.append(poly)
                match.evals.append(
                    [vals[pts.index(lhs)] for lhs in match.points]
                )
        else:
            diffs = [i for i in superset if i not in pts]
            sets.append(_EvalSet([poly], pts, diffs, [vals]))
    return sets, superset


def _set_scalars(sets, powers_of_gamma, points, z: Fp):
    vanishing_diff_evals = [s.vanishing_diff_eval(points, z) for s in sets]
    v0 = vanishing_diff_evals[0]
    normalizer = v0.inv() if not v0.is_zero() else Fp.one(z.spec)
    normalized = [
        normalizer * vde * g_pow
        for g_pow, vde in zip(powers_of_gamma, vanishing_diff_evals)
    ]
    return normalized, normalizer


def _vanishing_eval(points, z: Fp) -> Fp:
    acc = Fp.one(z.spec)
    for p in points:
        acc = acc * (z - p)
    return acc


def _comm_scalars(num_polys, sets, powers_of_beta, normalized_scalars):
    spec = powers_of_beta[0].spec
    scalars = [Fp.zero(spec)] * num_polys
    for s, coeff in zip(sets, normalized_scalars):
        for poly, b_pow in zip(s.polys, powers_of_beta):
            scalars[poly] = coeff * b_pow
    return scalars


def _powers(base: Fp, n: int) -> List[Fp]:
    out = []
    acc = Fp.one(base.spec)
    for _ in range(n):
        out.append(acc)
        acc = acc * base
    return out
