"""The controls of ``correct``: runs of a cell with a fault planted under the
timed path, each of which the check has to call not correct.  The
benchmark's own runs never plant one.

    python3 -m proofbench.control --workload <name> --fault <fault> --seeds 1,2,3 --seconds 10

Faults (systems/<system>.py ``FAULTS``): for a prove, ``witness`` (the
control: the prover is handed a witness with one gate broken, the guarantee
that a proof binds a satisfying witness) and ``answer`` (a byte of each
proof altered where it is produced); for a commitment, ``scalar`` (the
control: one evaluation altered, the guarantee that every evaluation is
bound), ``half`` (the second half of the points left out) and ``answer``
(the point negated).  Prints one JSON line per seed with the numbers
compared, and exits non-zero if any run came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    caught = True
    for seed in [int(s) for s in args.seeds.split(",")]:
        result = harness.run(args.workload, seed, args.seconds, False, device=args.device,
                             fault=args.fault)
        caught &= not result["correct"]
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
