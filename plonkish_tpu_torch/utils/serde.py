"""Checkpoint/resume of a Protostar accumulator with an explicit schema, no
pickle (port of plonkish_tpu/utils/serde.py, in the same container).

The container: a magic, a BLAKE2b-256 digest of the payload, then the
payload: an 8-byte little-endian header length, a JSON header (field and
curve names, the instance's scalars and commitments as hex integers) and an
``.npz`` blob with every polynomial as the reference's ``uint32[n, 16]``
16-bit digits (Montgomery form, ``convert.limbs_to_digits``).  A checkpoint
written by either package loads in the other.  Nothing in the format runs
code on load, and a changed byte of the payload fails the digest check (the
digest is integrity, not authenticity: keep checkpoints somewhere trusted if
forgery is a concern).
"""

from __future__ import annotations

import hashlib
import io
import json
from typing import Any

import numpy as np

from .. import resolve_device
from ..curves import specs as curve_specs
from ..curves.host import AffinePoint
from ..fields import spec as field_specs
from ..fields.host import Fp

_MAGIC = b"PLTPUACC2"


def _by_name(module, cls, name: str):
    for obj in vars(module).values():
        if isinstance(obj, cls) and obj.name == name:
            return obj
    raise ValueError(f"unknown {cls.__name__} {name!r}")


def _enc_fp(v) -> str:
    return hex(int(v))


def _enc_comm(comm) -> dict:
    if isinstance(comm, AffinePoint):
        return {
            "kind": "point",
            "curve": comm.curve.name,
            "x": _enc_fp(comm.x),
            "y": _enc_fp(comm.y),
            "inf": bool(comm.infinity),
        }
    root = getattr(comm, "root", None)
    if isinstance(root, bytes):
        return {"kind": "root", "type": type(comm).__name__, "root": root.hex()}
    raise TypeError(f"unsupported commitment type {type(comm).__name__}")


def _dec_comm(d: dict):
    if d["kind"] == "point":
        curve = _by_name(curve_specs, curve_specs.CurveSpec, d["curve"])
        return AffinePoint(
            curve,
            Fp(int(d["x"], 16), curve.base),
            Fp(int(d["y"], 16), curve.base),
            infinity=d["inf"],
        )
    if d["kind"] == "root":
        if d["type"] == "BrakedownCommitment":
            from ..pcs.brakedown import BrakedownCommitment

            return BrakedownCommitment(root=bytes.fromhex(d["root"]))
        raise ValueError(f"unknown root commitment type {d['type']!r}")
    raise ValueError(f"unknown commitment kind {d['kind']!r}")


def save(obj: Any) -> bytes:
    """Serialize a ProtostarAccumulator checkpoint."""
    from ..convert import limbs_to_digits

    if not hasattr(obj, "witness_polys"):
        raise TypeError("serde.save supports ProtostarAccumulator checkpoints only")
    inst = obj.instance
    header = {
        "spec": obj.e_poly.spec.name,
        "instance": {
            "instances": [[_enc_fp(v) for v in col] for col in inst.instances],
            "witness_comms": [_enc_comm(c) for c in inst.witness_comms],
            "challenges": [_enc_fp(c) for c in inst.challenges],
            "u": _enc_fp(inst.u),
            "e_comm": _enc_comm(inst.e_comm),
            "compressed_e_sum": (
                None if inst.compressed_e_sum is None else _enc_fp(inst.compressed_e_sum)
            ),
        },
        "num_witness_polys": len(obj.witness_polys),
    }
    arrays = {f"wp{i}": limbs_to_digits(p.evals) for i, p in enumerate(obj.witness_polys)}
    arrays["e_poly"] = limbs_to_digits(obj.e_poly.evals)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    hdr = json.dumps(header, separators=(",", ":")).encode()
    payload = len(hdr).to_bytes(8, "little") + hdr + buf.getvalue()
    digest = hashlib.blake2b(payload, digest_size=32).digest()
    return _MAGIC + digest + payload


def load(data: bytes, device=None) -> Any:
    """Deserialize a checkpoint produced by `save` (of either package) onto
    `device` (the card unless the caller says otherwise), after checking its
    digest."""
    from ..accumulation.protostar import (
        ProtostarAccumulator,
        ProtostarAccumulatorInstance,
    )
    from ..convert import digits_to_limbs
    from ..poly.multilinear import MLPoly

    device = resolve_device(device)
    if data[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not a plonkish_tpu checkpoint")
    digest = data[len(_MAGIC): len(_MAGIC) + 32]
    payload = data[len(_MAGIC) + 32:]
    if hashlib.blake2b(payload, digest_size=32).digest() != digest:
        raise ValueError("checkpoint integrity check failed")
    hdr_len = int.from_bytes(payload[:8], "little")
    header = json.loads(payload[8: 8 + hdr_len].decode())
    arrays = np.load(io.BytesIO(payload[8 + hdr_len:]))

    spec = _by_name(field_specs, field_specs.FieldSpec, header["spec"])

    def fp(h):
        return Fp(int(h, 16), spec)

    hi = header["instance"]
    instance = ProtostarAccumulatorInstance(
        instances=[[fp(v) for v in col] for col in hi["instances"]],
        witness_comms=[_dec_comm(c) for c in hi["witness_comms"]],
        challenges=[fp(c) for c in hi["challenges"]],
        u=fp(hi["u"]),
        e_comm=_dec_comm(hi["e_comm"]),
        compressed_e_sum=(
            None if hi["compressed_e_sum"] is None else fp(hi["compressed_e_sum"])
        ),
    )

    def poly(name):
        return MLPoly(spec, digits_to_limbs(arrays[name], device))

    return ProtostarAccumulator(
        instance=instance,
        witness_polys=[poly(f"wp{i}") for i in range(header["num_witness_polys"])],
        e_poly=poly("e_poly"),
    )
