"""Builds the CUDA sources of ``plonkish_tpu_torch/csrc`` into a shared
library with a plain C interface, loaded with ctypes.

The library is built at first use with ``nvcc`` for ``sm_90a`` into
``plonkish_tpu_torch/_build/`` (listed in .gitignore), one ``nvcc`` per source,
all started together.  A content hash of the sources names the library, so an
edited source gets a fresh build, and a file lock keeps parallel processes
from building at once.  There is no fallback: a failed build raises.

``build_cpu_twin`` compiles the same headers with g++ into a small library
for the CPU tests of the kernels' arithmetic; no entry point uses it.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
CUDA_SOURCES = ("msm.cu", "sumcheck.cu")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib: Optional[ctypes.CDLL] = None
ptxas_log = ""


def _digest(names) -> str:
    h = hashlib.sha256()
    for name in sorted(names):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _locked():
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / "lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_cuda() -> pathlib.Path:
    """Build (or find) the kernel library; returns its path."""
    global ptxas_log
    names = [p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")]
    tag = _digest(names)
    out = BUILD / f"libplonkish_cuda_{tag}.so"
    log = BUILD / f"libplonkish_cuda_{tag}.ptxas.txt"
    with _locked():
        if not out.exists():
            nvcc = _nvcc()
            procs = []
            for src in CUDA_SOURCES:
                obj = BUILD / f"{src}.{tag}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )))
            text = []
            for src, obj, proc in procs:
                output, _ = proc.communicate()
                text.append(f"== {src}\n{output}")
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src}:\n{output}")
            tmp = out.with_suffix(".tmp.so")
            subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                 "-o", str(tmp),
                 *[str(obj) for _, obj, _ in procs]],
                check=True,
            )
            log.write_text("\n".join(text))
            os.replace(tmp, out)
    ptxas_log = log.read_text() if log.exists() else ""
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build_cuda()))
    return _lib


def bind(fn, argtypes):
    """Declare a C entry point's argument types; every entry point returns
    an int (0 or a CUDA error code)."""
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_cpu_twin() -> pathlib.Path:
    """g++ build of csrc/cpu_twin.cpp (the headers on the host), for tests."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found")
    names = ["cpu_twin.cpp", "field.cuh", "curve.cuh"]
    out = BUILD / f"libplonkish_cpu_twin_{_digest(names)}.so"
    with _locked():
        if not out.exists():
            tmp = out.with_suffix(".tmp.so")
            subprocess.run(
                [gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                 str(CSRC / "cpu_twin.cpp"), "-o", str(tmp)],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, out)
    return out
