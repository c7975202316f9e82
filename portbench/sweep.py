"""The sweep that sets a camera mix's offered rate: runs the camera cell
at each given aggregate rate in one process and prints, for each, the
latency percentiles and how late the sources were handed frames (a
backlog that grows over the window means the rate is not sustained).
It reads latencies only, so it drives the cell's loop without the
comparison.

    python3 portbench/sweep.py --workload bf16-cameras-1080p \
        --rates 60,80,100 --seconds 15 --seed 7"""

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
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args()
    with open(run.ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    for rate in (float(r) for r in a.rates.split(",")):
        args = run.parse(["--workload", a.workload, "--seed", str(a.seed),
                          "--seconds", str(a.seconds)])
        args.rate = rate
        _, driver, ctx = run.prepare(args, spec)
        result = driver.run(ctx)
        print(json.dumps({"rate_fps": rate, "metrics": result["metrics"],
                          "extra": ctx.extra}), flush=True)
        del driver, ctx, result
        gc.collect()


if __name__ == "__main__":
    main()
