"""Run one cell of the benchmark once and print its result line:

    python3 -m proofbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run sets up, warms up every shape the cell's traffic uses, measures for
--seconds, checks what the window produced against the plain reference, and
prints the checks on standard error and one JSON object as the last line of
standard output.  It needs the card: without CUDA, or with fewer cards than
the cell asks for, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


def power_limit_w():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Fixed cache directories inside the checkout; the program's own nvcc
    # builds stay in plonkish_tpu_torch/_build/.
    cache = os.path.join(HERE, "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    if args.trace:
        os.environ["PLONKISH_TPU_TIMER"] = "1"

    from . import harness

    spec = harness.load_spec()
    workload, _ = harness.cell(spec, args.workload)
    t_torch = time.perf_counter()
    import torch

    t_cuda = time.perf_counter()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0  # CUDA initialises here
    t_end = time.perf_counter()
    start = {"start.import_torch": t_cuda - t_torch, "start.cuda_init": t_end - t_cuda}
    if cards < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} CUDA card(s); found {cards}",
              file=sys.stderr)
        return 2
    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START, start_phases=start)
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print("modules the port's runs must not load: " + ", ".join(found), file=sys.stderr)
        return 3
    watts = power_limit_w()
    if watts is not None:
        result["device"]["power_limit_w"] = watts
    sys.stderr.flush()
    print(harness.checks_text(result), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
