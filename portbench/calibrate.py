"""Readings that set a cell's limits: the compared numbers of the
program on many seeds and of the control on a few, in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 4 [--out FILE]

Each run is a whole run of the cell (``run.py``'s), with a short window.
Prints one JSON line a run: the side, the seed and the numbers; with
``--out`` also appends them to that file."""

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out")
    a = p.parse_args()
    with open(run.ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    plan = ([("program", int(s)) for s in a.seeds.split(",") if s]
            + [("control", int(s)) for s in a.control_seeds.split(",") if s])
    for side, seed in plan:
        args = run.parse(["--workload", a.workload, "--seed", str(seed),
                          "--seconds", str(a.seconds),
                          "--control", str(int(side == "control"))])
        out, _ = run.run_cell(args, spec)
        line = json.dumps({"workload": a.workload, "side": side,
                           "seed": seed, "correct": out["correct"],
                           "numbers": {k: v["value"] for k, v in
                                       out["checks"].items()},
                           "metrics": {k: v["value"] for k, v in
                                       out["metrics"].items()}})
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        gc.collect()


if __name__ == "__main__":
    main()
