"""The harness reads its cells, configurations, mixes, drivers, limits
and per-layer metrics as files found by name, and refuses malformed
names and units before a run."""

import copy
import json
import shutil

import pytest

from conftest import BENCH, ROOT, load, run_tiny
from harness.spec import validate


@pytest.fixture
def spec():
    return copy.deepcopy(load(ROOT / "BENCHMARK.json"))


def test_the_committed_benchmark_is_valid(spec):
    validate(spec, BENCH, ROOT)
    assert {w["name"] for w in spec["workloads"]} == {
        "bf16-offline-1080p", "int8-offline-1080p", "bf16-cameras-1080p"}
    assert all(w["chips"] == 1 for w in spec["workloads"])


@pytest.mark.parametrize("path, value", [
    (("workloads", 0, "name"), "bad name"),
    (("workloads", 0, "traffic"), "a/b"),
    (("end_to_end", 0, "name"), "frames per s"),
    (("end_to_end", 0, "unit"), "frames per second"),
    (("per_layer", 0, "unit"), "µs"),
    (("end_to_end", 0, "better"), "more"),
    (("configs", 0, "reduced"), ["num layers"]),
])
def test_malformed_names_and_units_are_refused(spec, path, value):
    node = spec
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    with pytest.raises(ValueError):
        validate(spec, BENCH, ROOT)


@pytest.mark.parametrize("missing", ["configs/terran-int8.json",
                                     "mixes/cameras-1080p.json",
                                     "drivers/offline.py",
                                     "limits/bf16-offline-1080p.json",
                                     "metrics/mfu.py"])
def test_a_missing_file_is_refused(spec, tmp_path, missing):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "portbench" / missing).unlink()
    with pytest.raises(ValueError):
        validate(spec, root / "portbench", root)


def test_a_new_cell_needs_only_new_files(tiny):
    """A configuration, a mix, a driver, limits and a per-layer metric,
    each added as a file of its own and named in the spec, run without
    an edit to any file the benchmark has."""
    run, spec = tiny
    bench = run.BENCH
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = load(bench / "configs" / "terran-bf16.json")
    cfg["pipeline"]["top_k"] = 8
    (bench / "configs" / "terran-bf16-k8.json").write_text(json.dumps(cfg))
    (bench / "drivers" / "offline_once.py").write_text(
        (bench / "drivers" / "offline.py").read_text())
    mix = dict(load(bench / "mixes" / "offline-1080p.json"),
               driver="offline_once")
    (bench / "mixes" / "offline-once.json").write_text(json.dumps(mix))
    (bench / "limits" / "k8-once.json").write_text(
        (bench / "limits" / "bf16-offline-1080p.json").read_text())
    (bench / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.frames)\n")
    spec["configs"].append(dict(spec["configs"][0], name="terran-bf16-k8",
                                file="portbench/configs/terran-bf16-k8.json"))
    spec["workloads"].append({"name": "k8-once", "config": "terran-bf16-k8",
                              "traffic": "offline-once", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "frames_seen", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "frames_per_s",
                              "workloads": ["k8-once"]})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("k8-once")
    out, lines = run_tiny(run, spec, "k8-once")
    assert out["correct"], lines
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    from harness.cell import Cell
    cell = Cell("k8-once", spec)
    assert cell.pipe_cfg["top_k"] == 8

    class Ctx:
        frames = 12
    assert run.read_per_layer(cell, Ctx())["frames_seen"]["value"] == 12.0
    assert all(p.read_bytes() == data for p, data in before.items())
