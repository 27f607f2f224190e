"""Time K6 and the IPA base fold of two trees of this repository on one CUDA
card, in turns, so that the two are compared within one run.

    python3 plonkish_tpu_torch/kernel_ab.py --parent DIR [--out FILE]

DIR holds another commit of the repository (for example ``git archive`` of
the parent commit, unpacked into a git-ignored directory).  Both trees'
kernel libraries are built first, in parallel; then each tree is timed in a
process of its own, in the order parent, this tree, this tree, parent.  A
process imports ``plonkish_tpu_torch`` from its tree and takes its inputs and
timers from this tree's ``chip_smoke.py``, so both trees run the same
measurement on the same inputs:

- K6, the Evaluations round at degree 5 from 32 pending bytes and the
  Coefficients round, each a launch in a CUDA graph of 100 launches
  (``graph_ms``, as phase 5 times them), each first held against its plain
  version;
- the IPA base fold ``L + xi * R`` (``kernels/ipa.py::base_fold_cuda``, one
  or two launches) at 2^19 points with phase 5's xi, timed with CUDA events
  over 3 calls; the points are 4,096 of the IPA basis repeated (a fold's
  time does not depend on which points it adds), and the fold is first held
  against its plain version on those 4,096.

Prints one JSON line a process and, last, every result as one JSON object
(also written to FILE).  Needs one card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import random
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLD_POINTS = 1 << 19
FOLD_DISTINCT = 1 << 12
K6_DEGREE = 5


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _use_tree(root):
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p) != os.path.dirname(
        os.path.abspath(__file__))]


def build_tree(root):
    _use_tree(root)
    from plonkish_tpu_torch.kernels import build

    print(json.dumps({"root": root, "library": build.build_cuda().name}), flush=True)


def time_tree(root):
    import torch

    _use_tree(root)
    smoke = _smoke()
    from plonkish_tpu_torch.curves.specs import GRUMPKIN_G1
    from plonkish_tpu_torch.fields import limb
    from plonkish_tpu_torch.fields.spec import BN254_FR
    from plonkish_tpu_torch.kernels import fiat_shamir as kfs
    from plonkish_tpu_torch.kernels import ipa as kipa
    from plonkish_tpu_torch.pcs.ipa import MultilinearIpa

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
    fold_ms = smoke.cuda_ms(torch, lambda: kipa.base_fold_cuda(curve, left, right, xi), 3)
    print(json.dumps({"root": root, "k6_round_us": round_us, "k6_coeff_us": coeff_us,
                      "fold_ms": fold_ms}), flush=True)


def _child(flag, root):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, root],
                          capture_output=True, text=True)
    sys.stderr.write(proc.stderr)
    if proc.returncode:
        raise SystemExit(f"{flag} {root} exited with {proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--out", help="also write the results here")
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        build_tree(args.build)
        return 0
    if args.time:
        time_tree(args.time)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("kernel_ab: needs a CUDA card and --parent", file=sys.stderr)
        return 2
    parent, change = os.path.abspath(args.parent), HERE
    builds = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build", root])
              for root in (parent, change)]
    if any(p.wait() for p in builds):
        raise SystemExit("a tree's kernel library did not build")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    for name, root in (("parent", parent), ("change", change), ("change", change),
                       ("parent", parent)):
        row = dict(_child("--time", root), tree=name)
        print(json.dumps(row), flush=True)
        runs.append(row)
    result = {"card": card, "runs": runs}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
