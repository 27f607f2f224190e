"""ctypes binding of the native batch Keccak-256 (port of
plonkish_tpu/ops/_keccak_native.py).

``csrc/keccak_native.cpp`` is built with g++ at first use into
``plonkish_tpu_torch/_build/`` (named by a hash of the source, under the
build lock).  A failed build raises: the port has no slower hasher to fall
back to on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import List

import numpy as np

from ..kernels import build

_SRC = build.CSRC / "keccak_native.cpp"
_lib = None


def _build():
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = build.BUILD / f"libkeccak_native_{tag}.so"
    with build._locked("lock.keccak"):
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the native Keccak-256 cannot be built")
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {_SRC.name}:\n{proc.stderr}")
            os.replace(tmp, out)
    return out


def lib():
    """The loaded hasher, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(_build()))
        handle.keccak256_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
            ctypes.c_char_p,
        ]
        handle.keccak256_batch.restype = None
        _lib = handle
    return _lib


def keccak256_many(blobs: List[bytes]) -> List[bytes]:
    n = len(blobs)
    if n == 0:
        return []
    buf = b"".join(blobs)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    out = ctypes.create_string_buffer(32 * n)
    lib().keccak256_batch(
        buf, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, out,
    )
    raw = out.raw
    return [raw[32 * i: 32 * i + 32] for i in range(n)]
