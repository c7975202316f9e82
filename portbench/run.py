"""The benchmark of ``terran_tpu_torch`` on one machine with an NVIDIA card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Reads the cell from ``BENCHMARK.json``,
finds its configuration, the bindings of the model families it names,
its mix, driver, limits and per-layer metrics by name under
``portbench/``, builds the program from the seed, measures
for ``--seconds`` seconds, compares what the timed path produced with
the plain reference, and prints one JSON line last on standard output.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from short profiler windows.

``--control 1`` judges the reference computed in the configuration's
control precision in the program's place (for setting limits; the
benchmark's own runs never pass it).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "portbench-cache"
# Kernel and compiler caches of the program and its libraries, at fixed
# paths inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "terran_tpu")
# Numbers read from the peak tables that the pipeline hands its pose
# assembly; the only ones a run may find nothing to read for.
PEAKS_UNRECORDED = ("peak_score_gap", "peak_max_gap", "peak_miss_gap")


def forbidden_modules(names):
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark may not load: the JAX stack and the JAX package (whose name
    the program's begins with)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card(cell):
    """The card the cell runs on; exits when the machine lacks the cards
    it asks for."""
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        raise SystemExit(f"portbench: cell {cell.name} needs {cell.chips} "
                         f"CUDA device(s); found "
                         f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


class Context:
    """What a driver and a metric reader see of a run."""

    def __init__(self, cell, args, device):
        from harness.trace import Tracer

        self.cell, self.device = cell, device
        self.seed, self.seconds = args.seed, float(args.seconds)
        self.trace = bool(args.trace)
        self.rate = getattr(args, "rate", None)
        self.tracer = Tracer(False, self.seconds, 0.0)
        self.weights = None
        self.setup_s = None
        self.timer = None
        # Running totals of the frames, embedded faces and batches
        # completed in the window, kept by the driver.
        self.done = SimpleNamespace(frames=0, faces=0, batches=0)
        self.frames = 0
        self.faces = None
        self.layer = {}
        self.extra = {}
        self.items = []

    def build_pipeline(self):
        from harness import cell as cellmod
        from harness.weights import make_weights

        config = self.cell.config
        self.weights = make_weights(config["weights_seed"], self.device,
                                    config["models"])
        return cellmod.build_pipeline(self.cell, self.weights, self.device)

    def setup_done(self, pipe):
        sync(self.device)
        self.setup_s = time.perf_counter() - T_START
        if self.trace:
            from harness.layers import ENQUEUE_STAGES
            from terran_tpu_torch.utils.profiling import StageTimer

            self.tracer.enabled = True
            self.tracer.warm()
            timer = self.timer = pipe.timer = StageTimer()
            self.tracer.watch(
                frames=lambda: self.done.frames,
                faces=lambda: self.done.faces,
                batches=lambda: self.done.batches,
                enqueue_s=lambda: sum(timer.times.get(s, 0.0)
                                      for s in ENQUEUE_STAGES),
                enqueue_calls=lambda: timer.counts.get("perception_step", 0))

    def window_opened(self, t0):
        from harness.trace import WINDOWS

        self.tracer.t0 = t0
        self.tracer.plan = [t0 + f * self.seconds for f in WINDOWS]

    def window_closed(self, frames, faces):
        import torch

        sync(self.device)
        self.frames, self.faces = frames, faces
        self.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                            if self.device.type == "cuda" else 0)
        self.stages = self.timer.summary() if self.timer else {}


def judge(ctx, result, control):
    """The compared numbers: the program's outputs (or, with ``control``,
    the control's) against the float32 reference."""
    import torch

    from harness import judge as J
    from reference.models import Quantized

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(ctx.cell.pipe_cfg)
    fams = ctx.cell.families
    reference = J.Reference(ctx.weights, cfg, fams)
    kinds = ctx.cell.config["control"]
    ctl = J.Reference(ctx.weights, cfg, fams,
                      ops={f.name: Quantized(kinds[f.name])
                           for f in fams.values()})
    numbers = {}
    with torch.inference_mode():
        for frames, cands in result["items"]:
            dev = torch.as_tensor(frames, device=ctx.device)
            J.compare_frames(reference, dev,
                             ctl.as_program(dev) if control else cands,
                             numbers)
    if result["tracks"] is not None:
        t = result["tracks"]
        numbers["track_mismatches"] = (
            0 if control else
            J.track_mismatches(t["calls"], t["max_age"], t["min_hits"]))
    return numbers


def read_per_layer(cell, ctx):
    """{name: {value, unit}} of the cell's per-layer metrics, each read by
    ``metrics/<name>.py``; a reader that finds nothing is left out."""
    metrics = {}
    for m in cell.per_layer:
        reader = load_file(BENCH / "metrics" / f"{m['name']}.py",
                           f"portbench_metric_{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def prepare(args, spec):
    """The cell, its driver and the run's context; exits when the machine
    lacks the cards the cell asks for."""
    from harness.cell import Cell
    from harness.spec import validate

    validate(spec, BENCH, BENCH.parent)
    cell = Cell(args.workload, spec)
    device = card(cell)
    driver = load_file(BENCH / "drivers" / f"{cell.mix['driver']}.py",
                       f"portbench_driver_{cell.mix['driver']}")
    return cell, driver, Context(cell, args, device)


def run_cell(args, spec):
    """One run of a cell: returns (result dict, checks lines). Exits, with
    nothing printed on standard output, if the run loaded a module of
    the JAX stack or the JAX package."""
    import torch

    cell, driver, ctx = prepare(args, spec)
    device = ctx.device
    result = driver.run(ctx)
    ctx.items = result["items"]

    if device.type == "cuda":
        torch.cuda.empty_cache()
    if args.trace:
        metrics = read_per_layer(cell, ctx)
    else:
        metrics = {}
        values = dict(result["metrics"], setup_s=ctx.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    # The cell's limits name the numbers it compares.
    numbers = {name: value for name, value in
               judge(ctx, result, args.control).items()
               if name in cell.limits}
    checks, lines, correct = {}, [], result["failed"] == 0
    unread = sorted(set(cell.limits) - set(numbers))
    if unread and set(unread) <= set(PEAKS_UNRECORDED):
        # The pipeline handed its pose assembly no peak tables in the
        # frames compared: those numbers have nothing to read.
        lines.append(f"check {' '.join(unread)} not compared: no peak "
                     f"tables reached the program's pose assembly")
    elif unread:
        correct = False
        lines.append(f"check missing: {unread}")
    for name, value in numbers.items():
        limit = cell.limits[name]
        ok = not math.isnan(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if ok else 'FAILED'}")
    out = {"correct": correct, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics,
           "device": {"platform": "gpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": cell.chips,
                      "memory_peak_bytes": ctx.memory_peak}}
    if args.trace and ctx.tracer.windows:
        out["device"]["busy_s"] = ctx.tracer.busy_s()
        out["device"]["window_s"] = ctx.tracer.window_s()
        out["breakdown"] = ctx.tracer.breakdown()
    out["card"] = power_limit()
    out["extra"] = dict(ctx.extra, setup_s=ctx.setup_s,
                        frames=ctx.frames, stages=ctx.stages,
                        not_compared=unread)
    out["checks"] = checks

    found = forbidden_modules(sys.modules)
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded: {found}")
    return out, lines


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    out, lines = run_cell(args, spec)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
