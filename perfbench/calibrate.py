"""The readings that each limit of ``correct`` is set from, on the chip.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 2]

Runs the cell's set-up, a short window of ``--seconds`` and the check in
one process for every seed: the program on ``--seeds`` (the lower
reading of each number: the largest over the seeds) and the control
(the reference in the precision below the configuration's, put in the
program's place) on ``--control-seeds`` (the upper reading: the
smallest).  Prints one JSON line per run, then a summary line.  The
benchmark's own runs never run this.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402

from perfbench import harness  # noqa: E402


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    readings: dict[str, dict[str, list]] = {"program": {}, "control": {}}
    for impl, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in (int(s) for s in seeds.split(",") if s):
            r = harness.run_cell(args.workload, seed, args.seconds, False, impl=impl)
            print(json.dumps({"impl": impl, "seed": seed, "correct": r["correct"],
                              "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
            for key, c in r["checks"].items():
                readings[impl].setdefault(key, []).append(c["value"])
            gc.collect()
    inf = float("inf")
    summary = {
        key: {"lower": max(inf if v is None else v for v in vals),
              "upper": min((inf if v is None else v)
                           for v in readings["control"].get(key, [None]))}
        for key, vals in readings["program"].items()
    }
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
