"""OpenPose's BODY_25 configuration (``terran-body25-pose``) and the batch-32
cell of ``terran-bf16``: the binding found by name, the pipeline keywords
it builds, its specs, the program's converter and the program's keys in
agreement, its operation count beside the other families' unchanged
ones, the two readers of the pose programs' records on planted timers, a
whole cell at a CPU's size with BODY_25 at narrow widths, and, on the
card, the cell at its published widths."""

import functools
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, load, run_tiny
from harness import bounds, families, flops
from run import BENCH, load_file

CELL = "body25-pose-offline-1080p"
B32 = "bf16-offline-1080p-b32"
CONFIG = "terran-body25-pose"


@pytest.fixture
def spec():
    return load(ROOT / "BENCHMARK.json")


def test_the_binding_is_found_by_name(spec):
    from harness.cell import Cell

    cell = Cell(CELL, spec)
    assert {r: f.name for r, f in cell.families.items()} == {
        "detector": "retinaface", "pose": "body25"}
    pose = cell.families["pose"].binding
    assert pose is families.binding("body25")
    assert (pose.ROLE, pose.PARTS) == ("pose", 25)
    assert pose.input_size(1080, 1920, cell.pipe_cfg) == (368, 654)
    assert cell.config["reduced"] == []
    entry = [e for e in spec["configs"] if e["name"] == CONFIG][0]
    assert entry["reduced"] == []
    assert cell.config["control"] == {"retinaface": "fp8", "body25": "fp8"}


def test_the_configuration_builds_a_body25_pose_pipeline(spec, monkeypatch):
    import terran_tpu_torch.pipeline as program
    import terran_tpu_torch.utils.convert as convert
    from harness import cell as cellmod

    monkeypatch.setattr(convert, "convert_body25", lambda sd: ("body25", sd))
    monkeypatch.setattr(convert, "convert_retinaface",
                        lambda sd: ("retinaface", sd))
    monkeypatch.setattr(program, "PerceptionPipeline",
                        lambda **kwargs: kwargs)
    cell = cellmod.Cell(CELL, spec)
    w = {"retinaface": object(), "body25": object()}
    got = cellmod.build_pipeline(cell, w, torch.device("cpu"))
    assert got["with_pose"] is True and got["with_embeddings"] is False
    assert got["pose"] == "body25"
    assert got["pose_params"] == ("body25", w["body25"])
    assert got["det_params"] == ("retinaface", w["retinaface"])
    assert "rec_params" not in got
    bf16 = load(BENCH / "configs" / "terran-bf16.json")
    assert cell.pipe_cfg == dict(bf16["pipeline"], pose_short_side=368)
    assert cell.config["models"]["retinaface"] == bf16["models"][
        "retinaface"]


def _meta(table):
    return flops._meta_state_dict(table)


def test_the_specs_the_converter_and_the_programs_keys_agree():
    from terran_tpu_torch.models import body25
    from terran_tpu_torch.utils.convert import convert_body25

    binding = families.binding("body25")
    sd = _meta(binding.specs())
    params = convert_body25(sd)
    with torch.device("meta"):
        model = body25.Body25Model()
    state = model.state_dict()
    assert params.keys() == state.keys() == sd.keys()
    for key, value in state.items():
        assert params[key].shape == value.shape == sd[key].shape, key
    assert model.load_state_dict(params, strict=True)
    assert sum(v.numel() for v in sd.values()) == 26_166_084


def test_the_counts():
    # 368 x 654, the pipeline's resize of a 1080p frame; 368 x 656 is
    # OpenPose's -1x368 at 1080p, ~287 GFLOP a frame.
    count = flops.model_flops("body25", 368, 654)
    assert count == 284_552_308_224
    assert abs(count / 287e9 - 1) < 0.02
    assert flops.model_flops("body25", 368, 656) == 287_261_035_520
    # The other families' counts as the benchmark has had them.
    assert flops.model_flops("retinaface", 416, 739) == 1_489_649_408
    assert flops.model_flops("openpose", 184, 327) == 118_614_914_048
    assert flops.model_flops("arcface", 112, 112) == 24_179_212_288


def test_the_b32_mix_and_limits_are_the_b8_cells(spec):
    b8 = load(BENCH / "mixes" / "offline-1080p.json")
    b32 = load(BENCH / "mixes" / "offline-1080p-b32.json")
    assert b32 == dict(b8, batch=32)
    assert (load(BENCH / "limits" / f"{B32}.json")
            == load(BENCH / "limits" / "bf16-offline-1080p.json"))
    cell = [c for c in spec["workloads"] if c["name"] == B32][0]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "terran-bf16", "offline-1080p-b32", 1)


def _ctx(spec, workload, times=None, counts=None, items=None):
    from harness.cell import Cell

    timer = None if times is None else SimpleNamespace(
        times=times, counts=counts, items=items)
    return SimpleNamespace(cell=Cell(workload, spec), timer=timer)


def reader(name):
    return load_file(BENCH / "metrics" / f"{name}.py", f"test_{name}")


def test_the_pose_readers_on_a_planted_timer(spec):
    ctx = _ctx(spec, CELL, times={"pose_device": 0.6},
               counts={"pose_device": 40}, items={"pose_device": 320})
    assert reader("pose_device_ms").read(ctx) == pytest.approx(15.0)
    assert reader("pose_mfu").read(ctx) == pytest.approx(
        100.0 * 320 * 284_552_308_224 / bounds.PEAK_BF16_FLOPS / 0.6)
    # The COCO model at 184 on the batch-32 cell.
    ctx = _ctx(spec, B32, times={"pose_device": 0.3},
               counts={"pose_device": 10}, items={"pose_device": 320})
    assert reader("pose_device_ms").read(ctx) == pytest.approx(30.0)
    assert reader("pose_mfu").read(ctx) == pytest.approx(
        100.0 * 320 * 118_614_914_048 / bounds.PEAK_BF16_FLOPS / 0.3)


@pytest.mark.parametrize("name", ["pose_device_ms", "pose_mfu"])
def test_the_pose_readers_find_nothing_without_records(spec, name):
    # No timer (an untraced run), or a program that keeps no such record
    # (the parent's): the line leaves the metric out.
    assert reader(name).read(_ctx(spec, CELL)) is None
    assert reader(name).read(_ctx(spec, CELL, times={"graph_replay": 0.0},
                                  counts={"graph_replay": 3},
                                  items={"graph_replay": 3})) is None


def test_the_pose_mfu_needs_a_pose_family(spec):
    assert reader("pose_mfu").read(_ctx(
        spec, "vitl-faces-offline-1080p", times={"pose_device": 0.1},
        counts={"pose_device": 1}, items={"pose_device": 8})) is None


def test_the_new_cells_are_in_the_lists(spec):
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in ("enqueue_ms", "launches_per_batch", "mfu",
                 "peaks_roofline", "nms_roofline", "device_idle_pct",
                 "idle_in_enqueue_pct", "graph_replay_pct",
                 "early_release_pct", "pose_device_ms", "pose_mfu"):
        assert {CELL, B32} <= set(per_layer[name]["workloads"]), name
    for name in ("embed_device_ms", "embed_mfu"):
        assert B32 in per_layer[name]["workloads"]
        assert CELL not in per_layer[name]["workloads"]
    rate = [m for m in spec["end_to_end"] if m["name"] == "frames_per_s"][0]
    assert {CELL, B32} <= set(rate["workloads"])


@pytest.fixture
def small_body25(monkeypatch):
    """The reference's BODY_25 at narrow widths, which the weights draw
    and the count follow (a binding loaded after this reads them)."""
    from reference import body25

    monkeypatch.setattr(body25, "body25_specs", functools.partial(
        body25.body25_specs, (8, 8, 16, 16, 16, 16, 16, 16, 32, 32, 16, 16),
        ((8, 16), (12, 24), (12, 24), (12, 24), (8, 16), (12, 24))))
    flops.model_flops.cache_clear()
    yield
    flops.model_flops.cache_clear()


def test_a_small_cell_is_correct_and_its_control_is_not(tiny, small_body25,
                                                        monkeypatch):
    from harness import cell as cellmod

    run, spec = tiny
    compared = []
    outputs_of = cellmod.outputs_of

    def recorded(peaks, out):
        compared.append(peaks is not None)
        return outputs_of(peaks, out)

    monkeypatch.setattr(cellmod, "outputs_of", recorded)
    out, lines = run_tiny(run, spec, CELL, seconds=3.0)
    assert out["correct"], lines
    assert compared and all(compared)
    assert set(out["checks"]) == set(load(BENCH / "limits" / f"{CELL}.json"))
    assert out["extra"]["not_compared"] == []
    out, lines = run_tiny(run, spec, CELL, control=1)
    assert not out["correct"], lines
    peaks = ("peak_score_gap", "peak_max_gap", "peak_miss_gap")
    assert any(out["checks"][n]["value"] > out["checks"][n]["limit"]
               for n in peaks), lines


@pytest.mark.card
def test_the_cell_is_correct_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 23), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["extra"]["not_compared"] == []
    assert out["device"]["platform"] == "gpu"
