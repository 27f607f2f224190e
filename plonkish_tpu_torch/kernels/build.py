"""Builds the CUDA sources of ``plonkish_tpu_torch/csrc`` into a shared
library with a plain C interface, loaded with ctypes.

The library is built at first use with ``nvcc`` for ``sm_90a`` into
``plonkish_tpu_torch/_build/`` (listed in .gitignore), one ``nvcc`` per source,
all started together.  A content hash of the sources names the library, so an
edited source gets a fresh build, and a file lock keeps parallel processes
from building at once.  There is no fallback: a failed build raises.

``build_cpu_twin`` compiles the same headers with g++ into a small library
for the CPU tests of the kernels' arithmetic; no entry point uses it.
K3's kernels, and K7's beside them, are generated for each expression and
built by ``kernels/sumcheck_gen.py`` with the same flags, lock and g++ twin.
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
CUDA_SOURCES = ("brakedown.cu", "convert.cu", "fiat_shamir.cu", "ipa.cu", "merkle.cu", "msm.cu",
                "msm_grumpkin.cu", "probe.cu", "sumcheck.cu")
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
def _locked(name: str = "lock"):
    BUILD.mkdir(parents=True, exist_ok=True)
    with open(BUILD / name, "w") as fh:
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


def build_host(src: pathlib.Path, out: pathlib.Path, opt: str = "-O2") -> pathlib.Path:
    """g++ build of one source (CUDA sources as C++, headers from csrc/) into
    a shared library at `out`, unless it is there already; for tests."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found")
    with _locked():
        if not out.exists():
            tmp = out.with_suffix(".tmp.so")
            subprocess.run(
                [gxx, opt, "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                 "-I", str(CSRC), str(src), "-o", str(tmp)],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, out)
    return out


def build_cpu_twin() -> pathlib.Path:
    """g++ build of csrc/cpu_twin.cpp (the headers on the host), for tests."""
    names = ["cpu_twin.cpp", "field.cuh", "field_ptx.cuh", "curve.cuh", "msm.cuh", "fiat_shamir.cuh",
             "fs_warp.cuh", "sumcheck.cuh", *CUDA_SOURCES]
    return build_host(CSRC / "cpu_twin.cpp",
                      BUILD / f"libplonkish_cpu_twin_{_digest(names)}.so")
