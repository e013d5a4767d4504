"""Readings that set a cell's correctness limits, on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 3]

In one process, for each seed, the run's start and chunks up to the
seed's checked window chunk (a window of one chunk, then the chunks up
to the drawn one, as ``run.py`` runs them), and the two checked chunks'
gaps to the float64 reference: the program's readings (the lower ones).
For the first ``--control-seeds`` seeds also the control's gaps: the
reference in TF32 in the program's place on the same inputs (the upper
readings).  The reference is the one the cell's configuration names,
found by the harness (``harness.resolve_reference``), so a new cell is
calibrated with no edit here.  Prints a JSON line a seed, then the
largest program reading and the smallest control reading of each number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    lower, upper = {}, {}
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        res = harness.run_cell(ROOT, args.workload, seed, 0.0, False,
                               t_start=t0, device="cuda",
                               control=i < args.control_seeds)
        row = {"seed": seed, "checks": {k: c["value"] for k, c in
                                        res["checks"].items()},
               "control": res.get("control"), "notes": res["notes"],
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        for k, v in row["checks"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in (row["control"] or {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
