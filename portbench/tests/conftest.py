"""The benchmark's own tests: run from the repository's root with
``python -m pytest portbench/tests``. Tests that need the card carry the
``card`` marker and skip without one."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

# A cell small enough for this CPU: every stage of the pipeline runs, at
# short sides of 64 and 2 frames a batch, in float32.
TINY_PIPELINE = {"det_short_side": 64, "pose_short_side": 64, "top_k": 16,
                 "max_faces": 2, "max_peaks": 4, "compute_dtype": "float32"}
TINY_FRAME = [96, 160]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def load(path):
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A copy of the benchmark under ``tmp_path`` whose configurations and
    mixes are cut to the tiny sizes, with the run's module and the family
    bindings pointed at it (its ``reference/`` searched after the
    benchmark's own, for the files a new family adds) and the card check
    replaced by the CPU. Returns (run module, spec)."""
    import torch

    import run
    from harness import cell as cellmod
    from harness import families

    root = tmp_path / "checkout"
    bench = root / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for path in (bench / "configs").glob("*.json"):
        cfg = load(path)
        cfg["pipeline"].update(TINY_PIPELINE)
        path.write_text(json.dumps(cfg))
    for path in (bench / "mixes").glob("*.json"):
        mix = load(path)
        mix.update(frame=TINY_FRAME, batch=2)
        if mix["driver"] == "offline":
            mix["batches"] = 2
        else:
            mix.update(cameras=2, rate_fps=2.0, sample_batches=2)
        path.write_text(json.dumps(mix))
    spec = copy.deepcopy(load(ROOT / "BENCHMARK.json"))
    monkeypatch.setattr(cellmod, "BENCH", bench)
    monkeypatch.setattr(cellmod, "ROOT", root)
    monkeypatch.setattr(run, "BENCH", bench)
    monkeypatch.setattr(families, "BENCH", bench)
    monkeypatch.setattr(sys, "path", sys.path + [str(bench)])
    monkeypatch.setattr(run, "card", lambda cell: torch.device("cpu"))
    return run, spec


def run_tiny(run, spec, workload, seed=3, seconds=2.0, **extra):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds)]
                     + [f"--{k}={v}" for k, v in extra.items()])
    return run.run_cell(args, spec)
