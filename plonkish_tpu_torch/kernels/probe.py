"""Kernel K5, the ``mont_mul`` chain probe, with its plain version.

K5 replaces scripts/validate_pallas_tpu.py::_chain_kernel (:253, launched by
``check_f32_mul``).  The CUDA source is ``csrc/probe.cu`` over
``csrc/field.cuh``.

``out[i] = a[i] * b[i]^chain * R^-chain mod p``: ``chain`` dependent
Montgomery products ``acc = mul(acc, b)`` per element, on Montgomery
``int32[n, 8]`` limbs.  ``variant`` names the multiplier: ``"u32"`` is the
integer product the other kernels use (``fe_mul``), ``"f32"`` the float32
byte-digit product (``fe_mul_f32``).  The two give equal results; the probe
exists to time them, and ``roofline.measure_peaks`` reads the card's
sustained products per second from it.

``per_thread`` (1, 2 or 4 independent elements per thread) and ``threads``
(block size) shape the launch and do not change the result.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields import soa
from . import LAUNCHES, field_id
from . import build

VARIANTS = ("u32", "f32")
PER_THREAD = (1, 2, 4)
MAX_BLOCKS = 132 * 64  # grid-stride beyond this many blocks

CHAIN_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(a: torch.Tensor, b: torch.Tensor, chain: int, variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if chain < 0:
        raise ValueError("chain must not be negative")
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 8:
            raise ValueError(f"{name} must be int32[n, 8], got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError("a and b must have one shape and one device")


def mont_mul_chain_plain(spec, a, b, chain: int = 16, variant: str = "u32"):
    """The same chain through ``fields/soa.py`` on whole tensors."""
    _check(a, b, chain, variant)
    mul = soa.mont_mul if variant == "u32" else soa.mont_mul_f32
    acc, y = soa.from_tensor(a), soa.from_tensor(b)
    for _ in range(chain):
        acc = mul(spec, acc, y)
    return soa.to_tensor(acc).contiguous()


def chain_launch(chain_fn, stream, spec, a, b, chain, variant, per_thread=1,
                 threads=256):
    """Launch K5 through `chain_fn` (``mont_mul_chain`` or its host twin)."""
    _check(a, b, chain, variant)
    if per_thread not in PER_THREAD:
        raise ValueError(f"per_thread must be one of {PER_THREAD}")
    n = a.shape[0]
    out = torch.empty_like(a)
    if n == 0:
        return out
    blocks = min(MAX_BLOCKS, -(-n // (threads * per_thread)))
    rc = chain_fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, chain,
                  field_id(spec), VARIANTS.index(variant), per_thread, blocks,
                  threads, stream)
    if rc != 0:
        raise RuntimeError(f"mont_mul_chain launch failed: error {rc}")
    LAUNCHES["mont_mul_chain"] += 1
    return out


def mont_mul_chain_cuda(spec, a, b, chain: int = 16, variant: str = "u32",
                        per_thread: int = 1, threads: int = 256):
    if a.device.type != "cuda":
        raise ValueError("a and b must be CUDA tensors")
    fn = build.bind(build.lib().mont_mul_chain, CHAIN_ARGS)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    return chain_launch(fn, stream, spec, a, b, chain, variant, per_thread, threads)


def mont_mul_chain(spec, a, b, chain: int = 16, variant: str = "u32",
                   per_thread: int = 1, threads: int = 256):
    """K5: `chain` dependent Montgomery products per element."""
    if a.device.type == "cpu":
        return mont_mul_chain_plain(spec, a, b, chain, variant)
    return mont_mul_chain_cuda(spec, a, b, chain, variant, per_thread, threads)
