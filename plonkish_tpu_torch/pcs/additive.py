"""Shared batch open/verify for additively homomorphic PCS (port of
plonkish_tpu/pcs/additive.py).

Reduces a batch of (poly, point, eval) claims to ONE opening with a degree-2
sum-check, following pcs/multilinear.rs:109-276 (challenge schedule, merged
polynomial weighting, g' construction).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..backend.pcs_api import Evaluation
from ..fields import limb
from ..fields.host import Fp
from ..fields.spec import FieldSpec
from ..piop.sum_check import ClassicSumCheck, VirtualPolynomial, eq_xy_eval
from ..poly.multilinear import MLPoly, eq_xy
from ..utils import expression as ex
from ..utils.expression import Query, Rotation
from ..utils.transcript import Keccak256Transcript


def batch_open(
    pcs,
    pp,
    num_vars: int,
    polys: Sequence[MLPoly],
    comms: Sequence,
    points: Sequence[Sequence[Fp]],
    evals: Sequence[Evaluation],
    transcript: Keccak256Transcript,
) -> None:
    spec = polys[0].spec
    device = polys[0].device
    ell = max(1, (len(evals) - 1).bit_length()) if len(evals) > 1 else 0
    t = transcript.squeeze_challenges(ell)

    eq_xt = eq_xy(spec, t, device).to_fps() if t else [Fp.one(spec)]

    # merged[point] = sum over its evals of eq_xt_i * poly_i
    # (multilinear.rs:153-171); a point with one eval keeps its scalar aside
    groups: dict = {}
    for eval_, eq_xt_i in zip(evals, eq_xt):
        groups.setdefault(eval_.point, []).append((eval_.poly, eq_xt_i))
    merged: List[MLPoly | None] = [None] * len(points)
    merged_scalar: List[Fp] = [Fp.one(spec)] * len(points)
    for pt, items in groups.items():
        if len(items) == 1:
            merged[pt] = polys[items[0][0]]
            merged_scalar[pt] = items[0][1]
        else:
            merged[pt] = MLPoly(spec, weighted_sum(
                spec, [polys[i].evals for i, _ in items], [s for _, s in items]
            ))

    active = [
        (idx, scalar, poly)
        for idx, (scalar, poly) in enumerate(zip(merged_scalar, merged))
        if poly is not None
    ]
    expression = None
    sum_polys = []
    for slot, (point_idx, scalar, poly) in enumerate(active):
        term = ex.eq_xy(point_idx) * ex.Polynomial(Query(slot, Rotation(0))) * scalar
        expression = term if expression is None else expression + term
        sum_polys.append(poly)

    tilde_gs_sum = Fp.zero(spec)
    for eval_, eq_xt_i in zip(evals, eq_xt):
        tilde_gs_sum = tilde_gs_sum + eval_.value * eq_xt_i

    vp = VirtualPolynomial(expression, sum_polys, [], [list(p) for p in points])
    challenges, _ = ClassicSumCheck.coefficients().prove(
        spec, num_vars, vp, tilde_gs_sum, transcript
    )

    # g' = sum (scalar * eq_xy_eval) * merged  (multilinear.rs:203-213)
    eq_xy_evals = [eq_xy_eval(challenges, list(p)) for p in points]
    g_prime = MLPoly(spec, weighted_sum(
        spec,
        [poly.evals for (_, _, poly) in active],
        [scalar * eq_xy_evals[point_idx] for (point_idx, scalar, _) in active],
    ))
    pcs.open(pp, g_prime, None, challenges, None, transcript)


def weighted_sum(spec: FieldSpec, tables, scalars) -> torch.Tensor:
    """sum scalars[i] * tables[i] over Montgomery [n, 8] tables: products are
    accumulated lazily as exact digits and reduced mod p once."""
    device = tables[0].device
    c = limb._consts(spec, device)
    acc = None
    for tbl, s in zip(tables, scalars):
        prod = limb.d_mul(limb.unpack(tbl), limb.d_const(spec, int(s), device), c)
        acc = prod if acc is None else acc + prod
    return limb.pack(limb.d_mul(limb.d_redc(acc, c), c["r2"], c))


def batch_verify(
    pcs,
    vp,
    num_vars: int,
    comms: Sequence,
    points: Sequence[Sequence[Fp]],
    evals: Sequence[Evaluation],
    transcript: Keccak256Transcript,
) -> None:
    spec = transcript.spec
    ell = max(1, (len(evals) - 1).bit_length()) if len(evals) > 1 else 0
    t = transcript.squeeze_challenges(ell)
    eq_xt = eq_xy(spec, t, "cpu").to_fps() if t else [Fp.one(spec)]

    tilde_gs_sum = Fp.zero(spec)
    for eval_, eq_xt_i in zip(evals, eq_xt):
        tilde_gs_sum = tilde_gs_sum + eval_.value * eq_xt_i

    g_prime_eval, challenges = ClassicSumCheck.coefficients().verify(
        spec, num_vars, 2, tilde_gs_sum, transcript
    )

    eq_xy_evals = [eq_xy_eval(challenges, list(p)) for p in points]
    scalars = [
        eq_xy_evals[eval_.point] * eq_xt_i
        for eval_, eq_xt_i in zip(evals, eq_xt)
    ]
    bases = [comms[eval_.poly] for eval_ in evals]
    g_prime_comm = pcs.combine_commitments(vp, scalars, bases)
    pcs.verify(vp, g_prime_comm, challenges, g_prime_eval, transcript)

