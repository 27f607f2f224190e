"""ctypes binding of the native multicore host field and curve runtime (port
of plonkish_tpu/ops/field_cpp.py): the baseline column of ``bench.py``.

``csrc/field_native.cpp`` (a copy of the JAX package's) is built with g++
``-O3 -march=native -fopenmp`` at first use into ``plonkish_tpu_torch/_build/``
(named by a hash of the source, under the build lock), as
``ops/_keccak_native.py`` builds its hasher; no g++ means an error.  The C++
takes ``uint32[..., 16]`` little-endian 16-bit digits; these wrappers take
and return the port's ``int32[..., 8]`` words on the CPU and convert at the
boundary.  Points cross as the port's affine storage (Montgomery, the
identity as (0, 0)); the C++ runs on homogeneous projective points.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

from ..curves.host import AffinePoint
from ..curves.specs import CurveSpec
from ..fields.host import Fp
from ..fields.spec import FieldSpec
from ..kernels import build

_SRC = build.CSRC / "field_native.cpp"
_lib = None
_u32p = ctypes.POINTER(ctypes.c_uint32)
_ARGS = {
    "register_field": ([_u32p, _u32p, _u32p, ctypes.c_uint64], ctypes.c_int),
    "register_curve": ([ctypes.c_int, _u32p], ctypes.c_int),
    "fe_add": ([ctypes.c_int, _u32p, _u32p, _u32p, ctypes.c_long, ctypes.c_long], None),
    "fe_mul": ([ctypes.c_int, _u32p, _u32p, _u32p, ctypes.c_long, ctypes.c_long,
                ctypes.c_long], None),
    "ec_msm": ([ctypes.c_int, _u32p, _u32p, _u32p, ctypes.c_long, ctypes.c_int], None),
}


def build_native():
    """Build (or find) the library; returns its path."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = build.BUILD / f"libfield_native_{tag}.so"
    with build._locked("lock.field_native"):
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the native field runtime cannot be built")
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [gxx, "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
                 str(_SRC), "-o", str(tmp)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {_SRC.name}:\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def lib():
    """The loaded runtime, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build_native()))
        for name, (argtypes, restype) in _ARGS.items():
            fn = getattr(handle, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = handle
    return _lib


def to_digits(words: torch.Tensor) -> np.ndarray:
    """int32[..., 8] -> contiguous uint32[..., 16] digits."""
    v = words.detach().to("cpu").contiguous().numpy().view(np.uint32)
    out = np.empty(v.shape[:-1] + (16,), dtype=np.uint32)
    out[..., 0::2] = v & np.uint32(0xFFFF)
    out[..., 1::2] = v >> np.uint32(16)
    return out


def from_digits(d: np.ndarray) -> torch.Tensor:
    """uint32[..., 16] digits -> int32[..., 8]."""
    words = (d[..., 0::2] | (d[..., 1::2] << np.uint32(16))).astype(np.uint32)
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def _int_digits(v: int) -> np.ndarray:
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(16)], dtype=np.uint32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u32p)


@functools.lru_cache(maxsize=None)
def field_id(spec: FieldSpec) -> int:
    n0inv64 = (-pow(spec.p, -1, 1 << 64)) % (1 << 64)
    p, r, r2 = (_int_digits(v) for v in (spec.p, spec.r_mod_p, spec.r2_mod_p))
    return lib().register_field(_ptr(p), _ptr(r), _ptr(r2), n0inv64)


@functools.lru_cache(maxsize=None)
def curve_id(curve: CurveSpec) -> int:
    fid = field_id(curve.base)
    return lib().register_curve(fid, _ptr(_int_digits(curve.base.to_mont(curve.b3))))


def _binary(name, spec, a, b):
    """An elementwise op over equal shapes, or b one element."""
    x, y = to_digits(a), to_digits(b)
    n = x.size // 16
    if y.size // 16 not in (1, n):
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} do not pair")
    out = np.empty_like(x)
    sb = 1 if y.size // 16 == n else 0
    if name == "fe_mul":
        lib().fe_mul(field_id(spec), _ptr(x), _ptr(y), _ptr(out), n, 1, sb)
    else:
        getattr(lib(), name)(field_id(spec), _ptr(x), _ptr(y), _ptr(out), n, sb)
    return from_digits(out)


def add(spec: FieldSpec, a, b) -> torch.Tensor:
    return _binary("fe_add", spec, a, b)


def mul(spec: FieldSpec, a, b) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p, elementwise."""
    return _binary("fe_mul", spec, a, b)


def ec_msm(curve: CurveSpec, scalars: torch.Tensor, points: torch.Tensor) -> AffinePoint:
    """sum_i scalars[i] * points[i] by the native Pippenger over every core.
    scalars: canonical int32[n, 8]; points: affine storage int32[n, 2, 8]."""
    n = points.shape[0]
    if scalars.shape[0] != n:
        raise ValueError(f"{scalars.shape[0]} scalars for {n} points")
    aff = to_digits(points)
    proj = np.zeros((n, 3, 16), dtype=np.uint32)
    proj[:, :2] = aff
    ident = ~aff.any(axis=(1, 2))
    proj[:, 2] = np.where(ident[:, None], np.uint32(0), _int_digits(curve.base.r_mod_p))
    proj[ident, 1] = _int_digits(curve.base.r_mod_p)  # (0 : 1 : 0)
    s = to_digits(scalars)
    window_bits = max(2, min(16, n.bit_length() - 1)) if n > 1 else 2  # the reference's choice
    out = np.empty((3, 16), dtype=np.uint32)
    lib().ec_msm(curve_id(curve), _ptr(s), _ptr(proj), _ptr(out), n, window_bits)
    spec = curve.base
    p, r_inv = spec.p, pow(1 << 256, -1, spec.p)
    x, y, z = (sum(int(v) << (16 * i) for i, v in enumerate(row)) * r_inv % p for row in out)
    if z == 0:
        return AffinePoint.identity(curve)
    zi = pow(z, -1, p)
    return AffinePoint(curve, Fp(x * zi % p, spec), Fp(y * zi % p, spec))
