"""The conversion between Montgomery and canonical form on the card
(``csrc/convert.cu``), for ``limb.from_mont`` and ``limb.to_mont``.

``out = k * x * R^-1 mod p`` elementwise for a constant ``k`` below p: k = 1
leaves Montgomery form, k = R^2 mod p enters it.  ``x`` is ``int32[..., 8]``
limbs of any value below 2^256; the output is a new tensor of x's shape,
reduced below p.  The plain version is ``limb.mont_mul`` by the same
constant, which ``limb`` takes on the CPU and for a field the kernels are
not built for (``kernels.FIELDS``).

One launch on the current stream, with no synchronisation and no read back;
``LAUNCHES["field_convert"]`` counts it.  The conversion opens every KZG
commit, where the card waits on the host until it is launched, so the host
path is kept short: the entry point bound once, each constant's limbs made
once, the stream read raw.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields.spec import FieldSpec
from . import LAUNCHES, build, field_id

THREADS = 256
PER_THREAD = 4  # csrc/convert.cu CONVERT_PER_THREAD: elements a thread holds at once
MAX_BLOCKS = 132 * 16  # grid-stride beyond this many blocks

CONVERT_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _limbs(k: int):
    """The constant's eight 32-bit limbs, read (never written) by the entry
    point before it returns; one constant per field and direction."""
    return (ctypes.c_uint32 * 8)(*[(k >> (32 * i)) & 0xFFFFFFFF for i in range(8)])


@functools.lru_cache(maxsize=None)
def _field_convert():
    return build.bind(build.lib().field_convert, CONVERT_ARGS)


def convert_launch(convert_fn, stream, spec: FieldSpec, x: torch.Tensor, k: int):
    """Launch the conversion through `convert_fn` (``field_convert`` or its
    host twin ``twin_field_convert``) and return its output."""
    fid = field_id(spec)
    if x.dtype != torch.int32 or x.dim() < 1 or x.shape[-1] != 8:
        raise ValueError(f"x must be int32[..., 8], got {x.dtype} {tuple(x.shape)}")
    if not 0 <= k < spec.p:
        raise ValueError("the constant must lie below p")
    if not x.is_contiguous() or x.data_ptr() % 16:  # views of Gemini, Brakedown
        x = x.clone(memory_format=torch.contiguous_format)
    out = torch.empty_like(x)
    n = x.numel() // 8
    if n == 0:
        return out
    blocks = min(MAX_BLOCKS, -(-n // (THREADS * PER_THREAD)))
    rc = convert_fn(x.data_ptr(), out.data_ptr(), n, _limbs(k), fid, blocks, THREADS, stream)
    if rc != 0:
        raise RuntimeError(f"field_convert launch failed: error {rc}")
    LAUNCHES["field_convert"] += 1
    return out


def field_convert_cuda(spec: FieldSpec, x: torch.Tensor, k: int) -> torch.Tensor:
    """``k * x * R^-1 mod p`` on the card, one launch."""
    if x.device.type != "cuda":
        raise ValueError("x must be a CUDA tensor")
    # PyTorch's current stream on x's card, as torch.cuda.current_stream(...)
    # .cuda_stream gives it, without building a Stream object (a few µs a
    # call warm, tens of µs after a commit's work has left the host's caches cold)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    return convert_launch(_field_convert(), stream, spec, x, k)
