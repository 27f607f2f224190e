"""Carry the reference's arrays and host points over to the port and back.

The reference (plonkish_tpu) keeps field elements as ``uint32[..., 16]``
16-bit digits in Montgomery form with R = 2^256; the port keeps the same
value as ``int32[..., 8]`` 32-bit limbs, so the conversion is an exact
repacking, ``l[i] = d[2i] | d[2i+1] << 16``.  Curve points are converted
through their coordinates as integers.  Nothing here imports the reference:
it takes its numpy arrays and reads its host objects' fields.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .curves import device as cdev
from .curves.host import AffinePoint
from .curves.pairing import Fq2, G2Point
from .curves.specs import BN254_G1, CurveSpec
from .fields import limb, soa
from .fields.host import Fp


def digits_to_limbs(digits, device="cpu") -> torch.Tensor:
    """uint32[..., 16] digits -> int32[..., 8] limbs (same value, same form)."""
    d = np.asarray(digits, dtype=np.uint32)
    limbs = (d[..., 0::2] | (d[..., 1::2] << np.uint32(16))).astype(np.uint32)
    return torch.from_numpy(limbs.view(np.int32).copy()).to(device)


def limbs_to_digits(limbs: torch.Tensor) -> np.ndarray:
    """int32[..., 8] limbs -> uint32[..., 16] digits."""
    v = limbs.detach().to("cpu").contiguous().numpy().view(np.uint32)
    out = np.empty(v.shape[:-1] + (16,), dtype=np.uint32)
    out[..., 0::2] = v & np.uint32(0xFFFF)
    out[..., 1::2] = v >> np.uint32(16)
    return out


def soa_from_reference(digits, device="cpu"):
    """The reference's struct-of-arrays element, a list of 16 ``uint32`` digit
    arrays (as numpy), -> (the port's list of 16 int64 digit tensors, the same
    elements as int32[..., 8] limbs)."""
    ds = [torch.from_numpy(np.asarray(d, dtype=np.uint32).astype(np.int64)).to(device)
          for d in digits]
    assert len(ds) == 16
    return ds, soa.to_tensor(ds)


def soa_to_reference(ds) -> List[np.ndarray]:
    """The port's digit list, or its int32[..., 8] limbs, -> the reference's
    list of 16 ``uint32`` digit arrays."""
    if isinstance(ds, torch.Tensor):
        ds = soa.from_tensor(ds)
    return [d.detach().to("cpu").numpy().astype(np.uint32) for d in ds]


def basis_from_reference(points, curve: CurveSpec = BN254_G1, device="cpu") -> torch.Tensor:
    """A reference KZG basis ``eqs[i]`` (homogeneous projective X:Y:Z,
    uint32[N, 3, 16]) -> the port's affine basis int32[N, 2, 8]."""
    t = digits_to_limbs(points, device)
    x, y, z = (limb.unpack(t[:, i]) for i in range(3))
    spec = curve.base
    c = limb._consts(spec, t.device)
    zi = limb.d_batch_inv(z, spec)
    inf = limb.d_is_zero(z)
    ax = torch.where(inf, torch.zeros_like(x), limb.d_mul(x, zi, c))
    ay = torch.where(inf, torch.zeros_like(y), limb.d_mul(y, zi, c))
    return torch.stack([limb.pack(ax), limb.pack(ay)], dim=1)


def basis_to_reference(basis: torch.Tensor, curve: CurveSpec = BN254_G1) -> np.ndarray:
    """The port's affine basis -> reference projective uint32[N, 3, 16]
    ((x : y : 1), identity (0 : 1 : 0))."""
    x, y, inf = cdev.unpack_affine(basis)
    one = limb._consts(curve.base, basis.device)["one"].expand_as(x)
    zero = torch.zeros_like(x)
    rows = [x, torch.where(inf, one, y), torch.where(inf, zero, one)]
    return limbs_to_digits(torch.stack([limb.pack(r) for r in rows], dim=1))


def g1_from_reference(point, curve: CurveSpec = BN254_G1) -> AffinePoint:
    if point.is_identity():
        return AffinePoint.identity(curve)
    return AffinePoint(curve, Fp(int(point.x), curve.base), Fp(int(point.y), curve.base))


def g2_from_reference(point) -> G2Point:
    if point.is_identity():
        return G2Point.identity()
    return G2Point(Fq2(*map(int, point.x)), Fq2(*map(int, point.y)))


def kzg_params_from_reference(param, device="cpu"):
    """A reference ``MultilinearKzgParams`` -> the port's, on `device`."""
    from .pcs.kzg import MultilinearKzgParams

    eqs: List[torch.Tensor] = [basis_from_reference(e, device=device) for e in param.eqs]
    return MultilinearKzgParams(
        g1=g1_from_reference(param.g1),
        eqs=eqs,
        g2=g2_from_reference(param.g2),
        ss=[g2_from_reference(s) for s in param.ss],
    )


# ---------------------------------------------------------------------------
# Protostar accumulators
# ---------------------------------------------------------------------------

def _comm_from_reference(comm):
    """A reference commitment (a host point, a list of them, a Brakedown
    commitment) -> the port's."""
    if isinstance(comm, (list, tuple)):
        return [_comm_from_reference(c) for c in comm]
    if hasattr(comm, "root"):
        from .pcs.brakedown import BrakedownCommitment

        return BrakedownCommitment(root=comm.root)
    from .curves import specs

    curve = {c.name: c for c in (specs.BN254_G1, specs.GRUMPKIN_G1)}[comm.curve.name]
    return g1_from_reference(comm, curve)


def _comm_to_reference(comm):
    """The port's commitment -> (x, y, is identity), a list of them, or the
    32-byte root."""
    if isinstance(comm, (list, tuple)):
        return [_comm_to_reference(c) for c in comm]
    if hasattr(comm, "root"):
        return comm.root
    if comm.is_identity():
        return (0, 0, True)
    return (int(comm.x), int(comm.y), False)


def accumulator_from_reference(acc, device="cpu"):
    """A reference ``ProtostarAccumulator`` -> the port's, its polynomials on
    `device`: instances, commitments, challenges, u, the compressed e sum,
    every witness polynomial and the e polynomial."""
    from .accumulation.protostar import ProtostarAccumulator, ProtostarAccumulatorInstance
    from .fields import spec as field_specs
    from .poly.multilinear import MLPoly

    inst = acc.instance
    spec = {s.name: s for s in (field_specs.BN254_FR, field_specs.BN254_FQ)}[acc.e_poly.spec.name]

    def fp(v):
        return Fp(int(v), spec)

    def poly(p):
        return MLPoly(spec, digits_to_limbs(p.evals, device))

    return ProtostarAccumulator(
        instance=ProtostarAccumulatorInstance(
            instances=[[fp(v) for v in col] for col in inst.instances],
            witness_comms=[_comm_from_reference(c) for c in inst.witness_comms],
            challenges=[fp(c) for c in inst.challenges],
            u=fp(inst.u),
            e_comm=_comm_from_reference(inst.e_comm),
            compressed_e_sum=None if inst.compressed_e_sum is None else fp(inst.compressed_e_sum),
        ),
        witness_polys=[poly(p) for p in acc.witness_polys],
        e_poly=poly(acc.e_poly),
    )


def accumulator_to_reference(acc) -> dict:
    """The port's ``ProtostarAccumulator`` in the reference's terms, as plain
    values: field elements as canonical ints, points as (x, y, is identity),
    polynomials as the reference's ``uint32[n, 16]`` digits.  The keys are
    the fields of the reference's accumulator and its instance."""
    inst = acc.instance
    return {
        "instances": [[int(v) for v in col] for col in inst.instances],
        "witness_comms": [_comm_to_reference(c) for c in inst.witness_comms],
        "challenges": [int(c) for c in inst.challenges],
        "u": int(inst.u),
        "e_comm": _comm_to_reference(inst.e_comm),
        "compressed_e_sum": None if inst.compressed_e_sum is None else int(inst.compressed_e_sum),
        "witness_polys": [limbs_to_digits(p.evals) for p in acc.witness_polys],
        "e_poly": limbs_to_digits(acc.e_poly.evals),
    }
