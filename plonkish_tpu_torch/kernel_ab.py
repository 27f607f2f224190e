"""Time hand-written kernels of two trees of this repository on one CUDA card,
in turns, so that the two are compared within one run.

    python3 plonkish_tpu_torch/kernel_ab.py --parent DIR [--kernels k7,k5] [--out FILE]

DIR holds another commit of the repository (for example ``git archive`` of
the parent commit, unpacked into a git-ignored directory).  Both trees'
kernel libraries (and K7's tape libraries) are built first, in parallel;
then each tree is timed in a process of its own, in the order parent, this
tree, this tree, parent.  A process imports ``plonkish_tpu_torch`` from its
tree and takes its inputs and timers from this tree's ``chip_smoke.py``, so
both trees run the same measurement on the same inputs.  Every kernel is
held against its plain version before it is timed.  The kernels, by name
(``--kernels``, all by default):

- ``k6``: K6, the Evaluations round at degree 5 from 32 pending bytes and the
  Coefficients round, each a launch in a CUDA graph of 100 launches
  (``graph_ms``, as phase 5 times them);
- ``ipa_fold``: the IPA base fold ``L + xi * R`` at 2^19 points with phase
  5's xi, CUDA events over 3 calls; the points are 4,096 of the IPA basis
  repeated (a fold's time does not depend on which points it adds);
- ``k7``: K7 on the vanilla zero-check at k = 20 (phase 5's state, 32 bytes
  pending): all 20 rounds, the 19 from round 1 (round 0's own time is the
  difference) and the 13 from 2^12 pairs, CUDA events over 3 runs each,
  K3's round 0 and the registers of K7's kernels; and, in a tree whose
  generator has it, the timing build of the same tape, whose phase stamps
  split round 0, a middle round and the tail's rounds into K7's phases
  (``csrc/sumcheck_fused.cuh``);
- ``k5``: K5's products (every variant the tree has) over its launch shapes
  at 2^22 elements 16 deep (``roofline.probe_sweep``): each one's best rate,
  and one product's latency in one thread (16 deep less no product, one
  element in a CUDA graph).

Prints one JSON line a process and, last, every result as one JSON object
(also written to FILE).  Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import random
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("k6", "ipa_fold", "k7", "k5")
FOLD_POINTS = 1 << 19
FOLD_DISTINCT = 1 << 12
K6_DEGREE = 5
K7_K = 20
K7_REPS = 3
K7_SUFFIXES = (0, 1, 7)  # first rounds timed: all, from round 1, the 13 from 2^12 pairs
K7_SPLIT_ROUNDS = (0, 10)  # and every tail round


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _use_tree(root):
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p) != os.path.dirname(
        os.path.abspath(__file__))]


def _vanilla_tape(torch, smoke, k, device):
    state, prover = smoke.zero_check_state(torch, k, torch.Generator().manual_seed(2), device)
    t = prover.tape
    return state, prover, (prover.instrs, t.num_regs, t.out_reg, state.stacked.shape[0],
                           state.degree, state.spec)


def _timing_defines(sumcheck_gen):
    """The timing build's macros, or None in a tree without one."""
    return (("timing", 1),) if "timing" in getattr(sumcheck_gen, "MEASURE_DEFINES", {}) else None


def build_tree(root, kernels):
    """The tree's kernel library and, for k7, the vanilla tape's library and
    its timing build, one nvcc each, all started together."""
    import torch

    _use_tree(root)
    from plonkish_tpu_torch.kernels import build, sumcheck_gen

    jobs = []
    if "k7" in kernels:
        smoke = _smoke()
        _, _, tape = _vanilla_tape(torch, smoke, 4, "cpu")
        timing = _timing_defines(sumcheck_gen)
        for defines in [()] + ([timing] if timing else []):
            src = (sumcheck_gen.source(*tape, defines=defines) if defines
                   else sumcheck_gen.source(*tape))
            cu, lib, log = sumcheck_gen._paths(src)
            if not lib.exists():
                build.BUILD.mkdir(parents=True, exist_ok=True)
                sumcheck_gen._write(cu, src)
                jobs.append((cu, lib, log))
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
        runs = [pool.submit(sumcheck_gen._nvcc_build, *job) for job in jobs]
        library = build.build_cuda().name
        seconds = [run.result() for run in runs]
    print(json.dumps({"root": root, "library": library, "tape_builds_s": seconds}), flush=True)


def time_k6(torch, smoke, root):
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import fiat_shamir as kfs

    spec, degree = BN254_FR, K6_DEGREE
    rng = random.Random(13)
    case = smoke.fs_round_case(torch, spec, degree, 32, rng)
    got = smoke.fs_round_outputs(torch, spec, degree, case, plain=False)
    want = smoke.fs_round_outputs(torch, spec, degree, case, plain=True)
    if not all(torch.equal(got[key], want[key]) for key in got):
        raise SystemExit(f"{root}: K6's Evaluations round differs from its plain version")
    out = torch.zeros((degree + 2, 8), dtype=torch.int32, device="cuda")
    chm = torch.zeros(8, dtype=torch.int32, device="cuda")
    ids = torch.zeros((3, 8), dtype=torch.int32, device="cuda")
    b = {k: v.clone() for k, v in case.items()}
    round_us = 1e3 * smoke.graph_ms(torch, lambda: kfs.round_cuda(
        spec, degree, b["sums"], b["scal"], b["sponge"], b["fixed"], b["rows"], out, chm, ids))
    v = limb.from_ints([spec.to_mont(rng.randrange(spec.p)) for _ in range(2)], "cuda")
    c0 = limb.from_ints([spec.to_mont(rng.randrange(spec.p))], "cuda")[0]
    scal, sponge = case["scal"][0].contiguous(), case["sponge"]
    cg = smoke.fs_coeff_outputs(torch, spec, v, scal, sponge, c0, plain=False)
    cw = smoke.fs_coeff_outputs(torch, spec, v, scal, sponge, c0, plain=True)
    if not all(torch.equal(cg[key], cw[key]) for key in cg):
        raise SystemExit(f"{root}: K6's Coefficients round differs from its plain version")
    s2, sp2 = scal.clone(), sponge.clone()
    cout = torch.zeros((4, 8), dtype=torch.int32, device="cuda")
    coeff_us = 1e3 * smoke.graph_ms(torch, lambda: kfs.coeff_cuda(spec, v, s2, sp2, c0, cout, chm))
    return {"k6_round_us": round_us, "k6_coeff_us": coeff_us}


def time_ipa_fold(torch, smoke, root):
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1
    from plonkish_tpu_torch.kernels import ipa as kipa
    from plonkish_tpu_torch.pcs.ipa import MultilinearIpa

    curve = GRUMPKIN_G1
    xi = random.Random(6).randrange(curve.scalar.p)
    basis = MultilinearIpa().setup(2 * FOLD_DISTINCT, 0).g
    small_l, small_r = basis[:FOLD_DISTINCT], basis[FOLD_DISTINCT:]
    if not torch.equal(kipa.base_fold_cuda(curve, small_l, small_r, xi),
                       kipa.base_fold_plain(curve, small_l, small_r, xi)):
        raise SystemExit(f"{root}: the IPA base fold differs from its plain version")
    reps = FOLD_POINTS // FOLD_DISTINCT
    left = small_l.repeat(reps, 1, 1).contiguous()
    right = small_r.repeat(reps, 1, 1).contiguous()
    return {"fold_ms": smoke.cuda_ms(torch, lambda: kipa.base_fold_cuda(curve, left, right, xi), 3)}


def _events_ms(torch, fn, stacked, reps=K7_REPS):
    """Mean ms of `fn(copy of stacked)` by CUDA events, after a warm-up, each
    run on a copy made before its events."""
    fn(stacked.clone())
    total = 0.0
    for _ in range(reps):
        copy = stacked.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(copy)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        del copy
    return total / reps


def _split(times, tail_from):
    """Phase durations of the rounds K7_SPLIT_ROUNDS and the mean of the
    tail's rounds (from `tail_from`): in us from %globaltimer, and in
    thousands of block 0's SM cycles from clock64 (within one kernel)."""
    names = ("sums", "barrier1", "reduce", "message", "barrier2", "fold", "barrier3")
    out = {}
    for clock, unit in ((0, "us"), (1, "kcycles")):
        t = times[:, :, clock].tolist()

        def one(j):
            row = {name: (t[j][i + 1] - t[j][i]) / 1e3 for i, name in enumerate(names)}
            row["round"] = ((t[j + 1][0] if j + 1 < len(t) else t[j][7]) - t[j][0]) / 1e3
            return row

        rows = {f"round_{j}": one(j) for j in K7_SPLIT_ROUNDS}
        tail = [one(j) for j in range(tail_from, len(t))]
        if tail:
            rows["tail_mean"] = {key: sum(r[key] for r in tail) / len(tail) for key in tail[0]}
            rows["tail_rounds"] = len(tail)
        out[unit] = rows
    return out


def time_k7(torch, smoke, root):
    from plonkish_tpu_torch.kernels import sumcheck as ksc
    from plonkish_tpu_torch.kernels import sumcheck_gen

    k = K7_K
    state, prover, tape = _vanilla_tape(torch, smoke, k, "cuda")
    spec, degree = state.spec, state.degree
    base = state.stacked
    bufs = smoke.fused_buffers(torch, spec, degree, k, 32, random.Random(17))
    case = (base, prover.instrs, prover.consts, tape[1], tape[2], degree, spec)
    want = smoke.fused_outputs(torch, case, bufs, plain=True)
    stream = torch.cuda.current_stream().cuda_stream
    ids = bufs["ids"]

    def check(name, outputs):
        if not all(torch.equal(outputs[key], want[key]) for key in want):
            raise SystemExit(f"{root}: K7 ({name}) differs from its plain version at k={k}")

    def suffixes(run):
        """ms of the rounds from each of K7_SUFFIXES to the last."""
        res = {}
        for r in K7_SUFFIXES:
            rows = base[:, : base.shape[1] >> r].contiguous()
            res[f"from_{r}"] = _events_ms(torch, lambda st: run(st, r), rows)
        res["round_0"] = res["from_0"] - res["from_1"]
        return res

    def shipped():
        check("shipped", smoke.fused_outputs(torch, case, bufs, plain=False))
        res = {"k7": suffixes(lambda st, r: smoke.fused_outputs(
            torch, (st, *case[1:]), bufs, False, r, k - r))}
        kern = sumcheck_gen.kernel(*tape)
        res["k7_regs"] = {"grid": kern.fused.regs, "grid_stack": kern.fused.stack,
                          "grid_warps": kern.fused.warps}
        if getattr(kern, "tail", None) is not None:
            res["k7_regs"].update(tail=kern.tail.regs, tail_stack=kern.tail.stack)
        k3_args = (base, prover.instrs, prover.consts, tape[1], tape[2], degree, ids)
        res["k3_round0_ms"] = smoke.cuda_ms(
            torch, lambda: ksc.sumcheck_round_cuda(spec, *k3_args), 3)
        return res

    def split(defines):
        kern = sumcheck_gen.kernel(*tape, defines=defines)
        times = torch.zeros((k, ksc.FUSED_PHASES, 2), dtype=torch.int64, device="cuda")

        def run(st):
            b = {n: v.clone() for n, v in bufs.items()}
            b["state"] = ksc.fused_launch(kern, stream, spec, st, prover.consts, degree,
                                          *(b[n] for n in smoke.FUSED_ORDER), 0, k, times=times)
            return b

        check("timing build", run(base.clone()))
        run(base.clone())  # the stamps of a second, warm run
        torch.cuda.synchronize()
        plan = ksc.tail_plan(kern.tail, base.shape[0], degree)
        half = base.shape[1] // 2
        tail_from = next((j for j in range(k) if plan and half >> j <= plan[2]), k)
        return dict(_split(times.cpu(), tail_from), tail_from=tail_from,
                    grid_regs=kern.fused.regs, grid_warps=kern.fused.warps,
                    tail_regs=kern.tail.regs)

    out = shipped()
    timing = _timing_defines(sumcheck_gen)
    if timing:
        out["k7_split"] = _guarded(lambda: split(timing))
    return out


def _guarded(fn):
    """fn()'s result, or what it raised: a failed phase split is reported
    beside the times already taken (the prove path has no such catch)."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - reported in the step's row
        return {"error": f"{type(e).__name__}: {e}"}


def time_k5(torch, smoke, root):
    from plonkish_tpu_torch import roofline
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import probe as kprobe

    gen = torch.Generator().manual_seed(1)
    a, b = smoke.probe_inputs(torch, BN254_FR, 1 << 16, gen)
    want = kprobe.mont_mul_chain_plain(BN254_FR, a, b, 16, "u32")
    for v in kprobe.VARIANTS:
        if not torch.equal(kprobe.mont_mul_chain_cuda(BN254_FR, a, b, 16, v), want):
            raise SystemExit(f"{root}: K5 variant {v} differs from its plain version")
    sweep = roofline.probe_sweep("cuda")
    products = roofline.PROBE_N * roofline.PROBE_CHAIN
    best = {}
    for variant, per_thread, threads, ms in sweep:
        if variant not in best or ms < best[variant]["ms"]:
            best[variant] = {"per_thread": per_thread, "threads": threads, "ms": ms,
                             "per_s": products / (ms * 1e-3)}
    one_a, one_b = a[:1].contiguous(), b[:1].contiguous()
    chain = roofline.PROBE_CHAIN
    for v in ("u32", "ptx"):
        if v not in kprobe.VARIANTS:
            continue
        one = {c: smoke.graph_ms(torch, lambda: kprobe.mont_mul_chain_cuda(
            BN254_FR, one_a, one_b, c, v, 1, 32)) for c in (0, chain)}
        best[v]["latency_ns"] = (one[chain] - one[0]) / chain * 1e6
    return {"k5": best}


TIMERS = {"k6": time_k6, "ipa_fold": time_ipa_fold, "k7": time_k7, "k5": time_k5}


def time_tree(root, kernels):
    import torch

    _use_tree(root)
    smoke = _smoke()
    row = {"root": root}
    for name in kernels:
        row.update(TIMERS[name](torch, smoke, root))
    print(json.dumps(row), flush=True)


def _child(flag, root, kernels):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, root,
                           "--kernels", ",".join(kernels)], capture_output=True, text=True)
    sys.stderr.write(proc.stderr)
    if proc.returncode:
        raise SystemExit(f"{flag} {root} exited with {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated, of {', '.join(KERNELS)}")
    ap.add_argument("--out", help="also write the results here")
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args()
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = [k for k in kernels if k not in TIMERS]
    if unknown:
        ap.error(f"unknown kernels {unknown}: choose from {', '.join(KERNELS)}")
    if args.build:
        build_tree(args.build, kernels)
        return 0
    if args.time:
        time_tree(args.time, kernels)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("kernel_ab: needs a CUDA card and --parent", file=sys.stderr)
        return 2
    parent, change = os.path.abspath(args.parent), HERE
    builds = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build", root,
                                "--kernels", ",".join(kernels)])
              for root in (parent, change)]
    if any(p.wait() for p in builds):
        raise SystemExit("a tree's kernel libraries did not build")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    for name, root in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        row = dict(_child("--time", root, kernels), tree=name)
        print(json.dumps(row), flush=True)
        runs.append(row)
    result = {"card": card, "kernels": kernels, "runs": runs}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
