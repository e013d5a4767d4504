"""Run one cell of the benchmark of the PyTorch/CUDA port on this
machine's card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard
output (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``, each compared
number with its limit) and the compared numbers last on standard error.
Exits non-zero, printing no result, where there is no CUDA card, fewer
cards than the cell asks for, or JAX or the JAX package was loaded.
``--help`` lists the cells.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _describe(root: str) -> str:
    """The cells and what each exercises, read from BENCHMARK.json and
    the files it names."""
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        return f"(no {path})"
    with open(path) as fh:
        spec = json.load(fh)
    confs = {c["name"]: c for c in spec["configs"]}
    lines = ["cells:"]
    for w in spec["workloads"]:
        conf = confs[w["config"]]
        lines.append(f"  {w['name']} ({w['chips']} chip): {w['why']}")
        lines.append(f"    configuration {conf['name']}: {conf['why']}")
        tpath = os.path.join(root, spec["paths"][0], "traffic",
                             w["traffic"] + ".json")
        if os.path.isfile(tpath):
            with open(tpath) as fh:
                lines.append(f"    traffic {w['traffic']}: "
                             f"{json.load(fh).get('why', '')}")
    lines.append("end-to-end metrics: " + ", ".join(
        f"{m['name']} ({m['unit']})" for m in spec["end_to_end"]))
    lines.append("per-layer metrics (--trace 1): " + ", ".join(
        f"{m['name']} ({m['unit']})" for m in spec["per_layer"]))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog=_describe(ROOT),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True, help="the cell's name")
    ap.add_argument("--seed", type=int, required=True,
                    help="makes the run's inputs")
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: the per-layer metrics, from a traced run")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness

    try:
        result = harness.run_cell(ROOT, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=T_START)
    except harness.CellError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print("benchmark: modules of JAX or the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
