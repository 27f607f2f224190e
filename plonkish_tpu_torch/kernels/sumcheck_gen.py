"""K3's generator: the round kernel's CUDA C++ for one expression tape, built
and loaded at first use.

The round kernel (``csrc/sumcheck.cuh``) is a template over a struct ``Tape``
whose ``eval`` computes the expression at one pair and one t.  ``source``
writes that struct from a compiled tape (piop/tape.py) whose leaf operands are
rows of the stacked state, as ``EvaluationsProver`` remaps them (row T, one
past the tables, is the identity leaf): one ``Fe`` local per tape register
and one statement per instruction, with no switch and no array indexed at run
time, so that nvcc keeps the registers in registers (a tape of more than
REGFILE_ABOVE registers keeps them in a local array instead, its statements
in out-of-line parts, since nvcc took minutes over one function of named
locals).  A constant is read from
the constant table at run time by its row, so the source depends on the
tape's structure and never on the constants' values: the proofs of one
circuit share one kernel whatever their challenges.

``kernel`` builds the source with nvcc (``build.NVCC_FLAGS``, sm_90a) into a
shared library of its own in ``_build/``, named by a hash of the source, the
headers and the flags, under the build lock; loads it with ctypes once per
process; and keeps its ptxas log and build seconds.  ``prebuild`` starts the
nvcc of several tapes together.  A failed build raises: there is no other
route.  ``twin`` builds the same source with g++ for the CPU tests, where
the launch entry point runs the kernel's threads one after another.

The same source holds K7, the fused sum-check rounds
(``csrc/sumcheck_fused.cuh``), instantiated with the same ``Tape``: one
nvcc a tape builds K3 and K7's two kernels (the grid rounds and the
cluster-resident tail), and the tape's out-of-line parts (``sc_mul``, the
REGFILE_PARTs) are compiled once for them.  ``RoundKernel.fused`` holds the
grid rounds' entry point and launch shape, ``RoundKernel.tail`` the tail's.

``defines`` adds preprocessor macros at the top of the source, for the
timing build of ``kernel_ab.py`` only (``MEASURE_DEFINES``: K7's phase
stamps).  The prove path never sets one.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import operator
import os
import pathlib
import re
import subprocess
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..fields.spec import BN254_FR, FieldSpec
from ..piop import tape as tape_mod
from ..utils import expression as ex
from . import build, field_struct

WARP = 32
# Tapes with more registers than this keep them in a local array
# (csrc/sumcheck.cuh sc_regfile) instead of named locals: 64 registers of eight
# words are twice the 255 a thread has.  Their statements are written in
# out-of-line parts of REGFILE_PART statements each, run in order on the same
# array, since nvcc's time grew faster than the length of one function.
REGFILE_ABOVE = 64
REGFILE_PART = 128
HEADERS = ("field.cuh", "field_ptx.cuh", "sumcheck.cuh", "fiat_shamir.cuh", "fs_warp.cuh",
           "sumcheck_fused.cuh")
ROUND_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p]
# sc_fused(a, b, tables, s0, consts, ids, partial, scal, sponge, fixed, rows, out,
#          ch_mont, bar, times, first, rounds, blocks, warps, capped, stream)
FUSED_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 11
              + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# sc_fused_tail(src, dst, tables, s0, consts, ids, scal, sponge, fixed, rows, out, ch_mont,
#               times, first, rounds, blocks, warps, smem, stream)
TAIL_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 9
             + [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p])
# The measurement build's macro (csrc/sumcheck_fused.cuh): K7's phase stamps.
MEASURE_DEFINES = {"timing": "PK_SC_FUSED_TIMING"}


@dataclasses.dataclass
class Launch:
    """K7's grid kernel: its entry point and launch shape."""

    fn: object
    warps: int  # warps per block
    resident: int  # blocks the card holds at once
    regs: int  # registers per thread (0 in the host build)
    stack: int  # local memory bytes per thread (0 in the host build)
    capped: int  # 1: the build capped at `max_threads` a block, 0: the uncapped one
    max_threads: int  # the capped build's thread limit (0: the uncapped build, the host build)
    ptxas: str = ""  # both builds' ptxas lines ("" in the host build)


@dataclasses.dataclass
class TailLaunch:
    """K7's tail kernel: its entry point and launch shape."""

    fn: object
    warps: int  # warps per block
    cluster: int  # the cluster's blocks (16, or 8 where the card places no 16)
    smem: int  # dynamic shared memory bytes a block may take
    regs: int  # registers per thread (0 in the host build)
    stack: int  # local memory bytes per thread (0 in the host build)
    ptxas: str = ""  # the kernel's ptxas lines ("" in the host build)


@dataclasses.dataclass
class RoundKernel:
    """One loaded tape library and what its build reported: K3's round
    kernel (the fields below) and K7's fused rounds (``fused``)."""

    fn: object  # sc_round(state, s, consts, ids, blocks, warps, partial, out, stream)
    degree: int
    warps: int  # warps (values of t) per block
    resident: int  # blocks the card holds at once
    regs: int  # registers per thread (0 in the host build)
    stack: int  # local memory bytes per thread (0 in the host build)
    path: pathlib.Path
    ptxas: str = ""  # the kernel's ptxas lines ("" in the host build)
    build_seconds: float = 0.0  # 0.0 when the library was already built
    fused: Launch = None  # sc_fused (FUSED_ARGS) and sc_fused_config's shape
    tail: TailLaunch = None  # sc_fused_tail (TAIL_ARGS) and sc_tail_config's shape
    defines: Tuple = ()  # the measurement macros the library was built with


_KERNELS: Dict[Tuple, RoundKernel] = {}  # by structure()
BUILDS: List[RoundKernel] = []  # every kernel this process loaded, in order


def structure(instrs, num_regs: int, out_reg: int, tables: int, degree: int,
              spec: FieldSpec = BN254_FR) -> Tuple:
    """What the generated source depends on (the cache key of a process)."""
    a = np.ascontiguousarray(instrs, dtype=np.int32)
    return (a.tobytes(), a.shape[0], int(num_regs), int(out_reg), int(tables), int(degree),
            field_struct(spec))


def _macros(defines) -> List[str]:
    """`defines`, (name, value) pairs of MEASURE_DEFINES' keys, as #define lines."""
    lines = []
    for key, value in defines:
        if key not in MEASURE_DEFINES:
            raise ValueError(f"unknown measurement macro {key!r}")
        lines.append(f"#define {MEASURE_DEFINES[key]} {int(value)}")
    return lines


def source(instrs, num_regs: int, out_reg: int, tables: int, degree: int,
           spec: FieldSpec = BN254_FR, defines: Tuple = ()) -> str:
    """C++ of the struct Tape and the library's entry points for one tape
    over `spec` (BN254 Fr or Fq); `defines` as ``_macros``."""
    instrs = np.asarray(instrs, dtype=np.int32)
    if degree < 1:
        raise ValueError(f"degree must be at least 1, got {degree}")
    field = field_struct(spec)
    ops = instrs[:, 0].tolist()
    regfile = num_regs > REGFILE_ABOVE
    r = (lambda j: f"r[{j}]") if regfile else (lambda j: f"r{j}")  # noqa: E731
    body = []
    for op, a, b, dst in instrs.tolist():
        if op == tape_mod.OP_ADD:
            rhs = f"sc_add<F>({r(a)}, {r(b)})"
        elif op == tape_mod.OP_MUL:
            rhs = f"sc_mul<F>({r(a)}, {r(b)})"
        elif op == tape_mod.OP_NEG:
            rhs = f"sc_neg<F>({r(a)})"
        elif op == tape_mod.OP_CONST:
            rhs = f"sc_const(consts, {a})"
        elif op == tape_mod.OP_LOAD and a == tables:
            rhs = "sc_identity<F>(ids, i, tm1)"
        elif op == tape_mod.OP_LOAD and 0 <= a < tables:
            rhs = f"sc_leaf<F>(state, s, {a}, i, tm1)"
        else:
            raise ValueError(f"bad tape instruction {(op, a, b, dst)} for {tables} tables")
        body.append(f"    {r(dst)} = {rhs};")
    args = ("const uint32_t* state, int64_t s, int64_t i, int tm1, const uint32_t* consts, "
            "const uint32_t* ids")
    parts = []
    if regfile:
        chunks = [body[j: j + REGFILE_PART] for j in range(0, len(body), REGFILE_PART)]
        for n, chunk in enumerate(chunks):
            parts += [f"  __host__ __device__ PK_SC_NOINLINE static void part{n}(Fe* r, {args}) {{",
                      "    (void)state, (void)s, (void)i, (void)tm1, (void)consts, (void)ids;",
                      *chunk, "  }"]
        body = [f"    part{n}(r, state, s, i, tm1, consts, ids);" for n in range(len(chunks))]
    regs = (f"Fe file[{num_regs}];\n    Fe* r = sc_regfile(file);" if regfile
            else f"Fe {', '.join(f'r{j}' for j in range(num_regs))};")
    return "\n".join([
        "// Generated by plonkish_tpu_torch/kernels/sumcheck_gen.py: the sum-check",
        f"// round kernel K3 and the fused rounds K7 for one expression tape ({len(ops)} "
        "instructions, "
        f"{ops.count(tape_mod.OP_MUL)} products,",
        f"// {num_regs} registers, {tables} tables, degree {degree}, over {spec.name}).",
        *_macros(defines),
        '#include "sumcheck_fused.cuh"',
        "",
        "namespace pk {",
        "",
        "struct Tape {",
        f"  using F = {field};",
        f"  static constexpr int DEGREE = {degree};",
        *parts,
        f"  PK_HD static Fe eval({args}) {{",
        "    (void)state, (void)consts, (void)ids;",
        f"    {regs}",
        *body,
        f"    return {r(out_reg)};",
        "  }",
        "};",
        "",
        "}  // namespace pk",
        "",
        'extern "C" int sc_round(const uint32_t* state, long long s, const uint32_t* consts,',
        "                        const uint32_t* ids, int blocks, int warps,",
        "                        uint32_t* partial, uint32_t* out, void* stream) {",
        "  return pk::sc_round_run<pk::Tape>(state, s, consts, ids, blocks, warps, partial,",
        "                                    out, stream);",
        "}",
        "",
        'extern "C" int sc_config(int* out) { return pk::sc_round_config<pk::Tape>(out); }',
        "",
        "// K7's grid rounds: rounds first .. first + rounds - 1 in one cooperative launch.",
        'extern "C" int sc_fused(uint32_t* a, uint32_t* b, long long tables, long long s0,',
        "                        const uint32_t* consts, uint32_t* ids, uint32_t* partial,",
        "                        uint32_t* scal, uint32_t* sponge, const uint32_t* fixed,",
        "                        const uint32_t* rows, uint32_t* out, uint32_t* ch_mont,",
        "                        uint32_t* bar, unsigned long long* times, int first, int rounds,",
        "                        int blocks, int warps, int capped, void* stream) {",
        "  pk::ScFused p{a, b, tables, s0, consts, ids, partial, scal, sponge, fixed, rows, out,",
        "                ch_mont, bar, times, first, rounds};",
        "  return pk::sc_fused_run<pk::Tape>(p, blocks, warps, capped, stream);",
        "}",
        "",
        'extern "C" int sc_fused_config(int* out) { return pk::sc_fused_config<pk::Tape>(out); }',
        "",
        "// K7's tail: rounds first .. first + rounds - 1 on one cluster of `blocks`.",
        'extern "C" int sc_fused_tail(uint32_t* src, uint32_t* dst, long long tables, long long s0,',
        "                             const uint32_t* consts, uint32_t* ids, uint32_t* scal,",
        "                             uint32_t* sponge, const uint32_t* fixed, const uint32_t* rows,",
        "                             uint32_t* out, uint32_t* ch_mont, unsigned long long* times,",
        "                             int first, int rounds, int blocks, int warps, long long smem,",
        "                             void* stream) {",
        "  pk::ScFused p{src, dst, tables, s0, consts, ids, nullptr, scal, sponge, fixed, rows, out,",
        "                ch_mont, nullptr, times, first, rounds};",
        "  return pk::sc_tail_run<pk::Tape>(p, blocks, warps, smem, stream);",
        "}",
        "",
        'extern "C" int sc_tail_config(int* out) { return pk::sc_tail_config<pk::Tape>(out); }',
        "",
    ])


def digest(src: str, flags: Sequence[str]) -> str:
    """Names a library: the generated source, the headers it includes and
    the compiler flags."""
    h = hashlib.sha256(src.encode())
    for name in HEADERS:
        h.update((build.CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _paths(src: str):
    tag = digest(src, build.NVCC_FLAGS)
    return (build.BUILD / f"sc_round_{tag}.cu", build.BUILD / f"libsc_round_{tag}.so",
            build.BUILD / f"libsc_round_{tag}.ptxas.txt")


def _kernel_ptxas(log: str, kernel: str = "sc_round_kernel") -> str:
    """What ptxas reports for `kernel` (sc_round_kernel, sc_fused_kernel, with
    its capped build as sc_fused_kernel_capped, or sc_tail_kernel), sc_mul
    and K7's out-of-line message: registers, stack frame, spills."""
    out, subject = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )(\S+?)'?(?: for|$)",
                      line.strip())
        if m:
            name = m.group(1)
            subject = next((k for k in (kernel, "sc_mul", "sc_fused_message") if k in name),
                           None)
            if subject == "sc_fused_kernel" and "sc_fused_kernel_capped" in name:
                subject = "sc_fused_kernel_capped"  # the grid kernel's capped build
            continue
        if subject and ("stack frame" in line or "Used" in line):
            out.append(f"{subject}: " + re.sub(r"^ptxas info\s*:\s*", "", line.strip()))
    return "; ".join(out)


def _write(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _config(lib, name: str, path: pathlib.Path, count: int = 4):
    cfg = (ctypes.c_int * count)()
    rc = build.bind(getattr(lib, name), [ctypes.c_void_p])(ctypes.addressof(cfg))
    if rc != 0:
        raise RuntimeError(f"{name} of {path.name} failed: CUDA error {rc}")
    return list(cfg)


def _open(path: pathlib.Path, degree: int, log: str = "", seconds: float = 0.0,
          defines: Tuple = ()) -> RoundKernel:
    """Load a built library and ask it for its kernels' launch shapes."""
    lib = ctypes.CDLL(str(path))
    warps, resident, regs, stack = _config(lib, "sc_config", path)
    fused = Launch(build.bind(lib.sc_fused, FUSED_ARGS),
                   *_config(lib, "sc_fused_config", path, 6),
                   ptxas=_kernel_ptxas(log, "sc_fused_kernel"))
    tail = TailLaunch(build.bind(lib.sc_fused_tail, TAIL_ARGS),
                      *_config(lib, "sc_tail_config", path, 5),
                      ptxas=_kernel_ptxas(log, "sc_tail_kernel"))
    return RoundKernel(fn=build.bind(lib.sc_round, ROUND_ARGS), degree=degree, warps=warps,
                       resident=resident, regs=regs, stack=stack, path=path,
                       ptxas=_kernel_ptxas(log), build_seconds=seconds, fused=fused, tail=tail,
                       defines=tuple(defines))


def _nvcc_build(cu: pathlib.Path, lib: pathlib.Path, log: pathlib.Path) -> float:
    """One nvcc run: source -> shared library, ptxas log kept; its seconds."""
    t0 = time.time()
    tmp = lib.with_suffix(".tmp.so")
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(build.CSRC), str(cu),
         "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stdout}")
    log.write_text(proc.stdout)
    tmp.replace(lib)
    return time.time() - t0


def prebuild(tapes: Sequence[Tuple], defines: Tuple = ()) -> List[RoundKernel]:
    """Kernels for several tapes (instrs, num_regs, out_reg, tables, degree
    [, spec]), with the measurement macros `defines` (none on the prove
    path); the missing ones are built together, one nvcc for each, all
    started at once."""
    defines = tuple(defines)
    keys = [structure(*t) + (defines,) for t in tapes]
    todo = {}
    for key, t in zip(keys, tapes):
        if key not in _KERNELS:
            todo.setdefault(key, source(*t, defines=defines))
    if todo:
        with build._locked("lock.sc_round"):
            jobs = {}
            for key, src in todo.items():
                cu, lib, log = _paths(src)
                if not lib.exists():
                    _write(cu, src)
                    jobs[key] = (cu, lib, log)
            with concurrent.futures.ThreadPoolExecutor(max(1, len(jobs))) as pool:
                runs = {key: pool.submit(_nvcc_build, *job) for key, job in jobs.items()}
                seconds = {key: run.result() for key, run in runs.items()}
        for key, src in todo.items():
            _, lib, log = _paths(src)
            text = log.read_text() if log.exists() else ""
            _KERNELS[key] = _open(lib, key[5], text, seconds.get(key, 0.0), defines)
            BUILDS.append(_KERNELS[key])
    return [_KERNELS[key] for key in keys]


def kernel(instrs, num_regs: int, out_reg: int, tables: int, degree: int,
           spec: FieldSpec = BN254_FR, defines: Tuple = ()) -> RoundKernel:
    """The CUDA round kernel of one tape over `spec`, built at its first use
    (`defines`: the measurement macros, as ``prebuild``)."""
    return prebuild([(instrs, num_regs, out_reg, tables, degree, spec)], defines)[0]


def twin(instrs, num_regs: int, out_reg: int, tables: int, degree: int,
         opt: str = "-O1", spec: FieldSpec = BN254_FR) -> RoundKernel:
    """The same generated source built with g++ (CPU tests only): sc_round
    runs the kernel's blocks and lanes one after another, sc_fused and
    sc_fused_tail K7's."""
    src = source(instrs, num_regs, out_reg, tables, degree, spec)
    tag = digest(src, ["g++", opt])
    cu = build.BUILD / f"sc_round_twin_{tag}.cu"
    lib_path = build.BUILD / f"libsc_round_twin_{tag}.so"
    if not lib_path.exists():
        build.BUILD.mkdir(parents=True, exist_ok=True)
        _write(cu, src)
    build.build_host(cu, lib_path, opt)
    return _open(lib_path, degree)


def wide_expression():
    """A tape beyond the limits of the interpreter K3 had before it was
    generated (32 registers, 40 leaves, degree 8), for the checks of the
    generated kernel: 41 tables and the identity at degree 9, every table
    live from the first sum to the second.  Returns (expression, tables)."""
    P = lambda i: ex.Polynomial(ex.Query(i, ex.Rotation(0)))  # noqa: E731
    n = 41
    first = functools.reduce(operator.add, [P(j) for j in range(n)])
    second = functools.reduce(operator.add, [P(j) * P((j + 1) % n) for j in range(n)])
    prod = functools.reduce(operator.mul, [P(j) for j in range(6)])
    return first * second * prod + ex.identity() * P(7), n
