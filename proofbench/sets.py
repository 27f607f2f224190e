"""Runs of the benchmark in turn, each a process of its own as the check
makes them, and the spread of their metrics.

    python3 -m proofbench.sets --out runs.jsonl --seconds 51 \\
        --run <workload>:<seed>:<trace> [--run ...]

Each run appends one JSON line to --out: the workload, seed and trace, the
exit code, the wall seconds, the result line (or null) and the end of its
standard error.  At the end a line per workload and trace gives each
metric's median and the spread between its quartiles as a share of the
median (``statistics.quantiles(values, n=4)``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--run", action="append", required=True, help="workload:seed:trace")
    ap.add_argument("--timeout", type=float, default=1500)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    records = []
    for item in args.run:
        workload, seed, trace = item.split(":")
        cmd = [sys.executable, "-m", "proofbench.run", "--workload", workload, "--seed", seed,
               "--seconds", args.seconds, "--trace", trace]
        t0 = time.perf_counter()
        try:
            p = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=args.timeout)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = 124, e.stdout or "", e.stderr or ""
            out = out.decode() if isinstance(out, bytes) else out
            err = err.decode() if isinstance(err, bytes) else err
        wall = time.perf_counter() - t0
        lines = out.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"workload": workload, "seed": int(seed), "trace": int(trace), "rc": rc,
               "wall_s": wall, "result": result, "stderr_tail": err[-3000:]}
        records.append(rec)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        brief = {k: v["value"] for k, v in (result or {}).get("metrics", {}).items()}
        print(json.dumps({"workload": workload, "seed": int(seed), "trace": int(trace), "rc": rc,
                          "wall_s": round(wall, 1),
                          "correct": (result or {}).get("correct"), "metrics": brief,
                          "checks": (result or {}).get("checks"),
                          "setup_phases": (result or {}).get("setup_phases"),
                          "request_s": (result or {}).get("request_s"),
                          "gc_window": (result or {}).get("gc_window"),
                          "check_s": (result or {}).get("check_s")}), flush=True)
    groups = {}
    for rec in records:
        if rec["result"]:
            groups.setdefault((rec["workload"], rec["trace"]), []).append(rec["result"])
    for (workload, trace), results in groups.items():
        names = sorted({n for r in results for n in r["metrics"]})
        summary = {}
        for n in names:
            vals = [r["metrics"][n]["value"] for r in results if n in r["metrics"]]
            summary[n] = {"median": statistics.median(vals), "spread": spread(vals), "n": len(vals)}
        print(json.dumps({"summary": workload, "trace": trace, "metrics": summary}), flush=True)
    return 0 if all(r["rc"] == 0 for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
