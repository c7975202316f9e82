"""The ViT-L recognizer's configuration (``terran-vitl-faces``): its
binding found by name, the pipeline keywords it builds, its operation
count beside the other families' unchanged ones, the two readers of the
embed programs' records on planted timers, a whole cell at a CPU's size
with the ViT cut to 2 blocks of width 64, and, on the card, the cell at
its published widths."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT, load, run_tiny
from harness import bounds, embed, families, flops
from run import BENCH, load_file

CELL = "vitl-faces-offline-1080p"
CONFIG = "terran-vitl-faces"


@pytest.fixture
def spec():
    return load(ROOT / "BENCHMARK.json")


def test_the_binding_is_found_by_name(spec):
    from harness.cell import Cell

    cell = Cell(CELL, spec)
    assert {r: f.name for r, f in cell.families.items()} == {
        "detector": "retinaface", "recognizer": "vit_l"}
    rec = cell.families["recognizer"].binding
    assert rec is families.binding("vit_l")
    assert (rec.ROLE, rec.EMBED_DIM, rec.ATTENTION) == (
        "recognizer", 512, "float32")
    assert rec.input_size(1080, 1920, cell.pipe_cfg) == (112, 112)
    assert cell.config["reduced"] == []
    assert [e for e in spec["configs"] if e["name"] == CONFIG][0][
        "reduced"] == []


def test_the_configuration_builds_a_faces_only_vit_pipeline(spec,
                                                            monkeypatch):
    import terran_tpu_torch.pipeline as program
    import terran_tpu_torch.utils.convert as convert
    from harness import cell as cellmod

    monkeypatch.setattr(convert, "convert_vit_l", lambda sd: ("vit_l", sd))
    monkeypatch.setattr(convert, "convert_retinaface",
                        lambda sd: ("retinaface", sd))
    monkeypatch.setattr(program, "PerceptionPipeline",
                        lambda **kwargs: kwargs)
    cell = cellmod.Cell(CELL, spec)
    w = {"retinaface": object(), "vit_l": object()}
    got = cellmod.build_pipeline(cell, w, torch.device("cpu"))
    assert got["with_pose"] is False and got["with_embeddings"] is True
    assert got["recognizer"] == "vit_l"
    assert got["rec_params"] == ("vit_l", w["vit_l"])
    assert got["det_params"] == ("retinaface", w["retinaface"])
    assert "pose_params" not in got
    bf16 = load(BENCH / "configs" / "terran-bf16.json")
    assert cell.pipe_cfg == bf16["pipeline"]
    assert cell.config["models"]["retinaface"] == bf16["models"][
        "retinaface"]


def test_the_counts():
    assert flops.model_flops("vit_l", 112, 112) == 50_675_589_120
    assert embed.split_flops("vit_l", 112, 112) == (50_675_589_120,
                                                    1_528_823_808)
    # The other families' counts as the benchmark has had them.
    assert flops.model_flops("retinaface", 416, 739) == 1_489_649_408
    assert flops.model_flops("openpose", 184, 327) == 118_614_914_048
    assert flops.model_flops("arcface", 112, 112) == 24_179_212_288
    assert embed.split_flops("arcface", 112, 112) == (24_179_212_288, 0)


def _ctx(spec, workload, times=None, counts=None, items=None):
    from harness.cell import Cell

    timer = None if times is None else SimpleNamespace(
        times=times, counts=counts, items=items)
    return SimpleNamespace(cell=Cell(workload, spec), timer=timer)


def reader(name):
    return load_file(BENCH / "metrics" / f"{name}.py", f"test_{name}")


def test_the_embed_readers_on_a_planted_timer(spec):
    ctx = _ctx(spec, CELL, times={"embed_device": 0.5},
               counts={"embed_device": 50, "embed_slots": 50},
               items={"embed_device": 3000, "embed_slots": 3200})
    assert reader("embed_device_ms").read(ctx) == pytest.approx(10.0)
    face = (49_146_765_312 / bounds.PEAK_BF16_FLOPS
            + 1_528_823_808 / bounds.PEAK_FP32_OPS)
    assert reader("embed_mfu").read(ctx) == pytest.approx(
        100.0 * 3000 * face / 0.5)
    # FaceResNet100 has no products of two activations: all at bf16.
    ctx = _ctx(spec, "bf16-offline-1080p", times={"embed_device": 0.2},
               counts={"embed_device": 40}, items={"embed_device": 2560})
    assert reader("embed_device_ms").read(ctx) == pytest.approx(5.0)
    assert reader("embed_mfu").read(ctx) == pytest.approx(
        100.0 * 2560 * 24_179_212_288 / bounds.PEAK_BF16_FLOPS / 0.2)


@pytest.mark.parametrize("name", ["embed_device_ms", "embed_mfu"])
def test_the_embed_readers_find_nothing_without_records(spec, name):
    assert reader(name).read(_ctx(spec, CELL)) is None
    assert reader(name).read(_ctx(spec, CELL, times={"graph_replay": 0.0},
                                  counts={"graph_replay": 3},
                                  items={"graph_replay": 3})) is None


@pytest.fixture
def small_vit(monkeypatch):
    """The reference's ViT cut to 2 blocks of width 64 (8 heads of 8),
    which the weights draw and the count follow."""
    from reference import vit_l

    monkeypatch.setattr(vit_l, "DEPTH", 2)
    monkeypatch.setattr(vit_l, "DIM", 64)
    monkeypatch.setattr(vit_l, "MLP_DIM", 256)
    flops.model_flops.cache_clear()
    embed.split_flops.cache_clear()
    yield
    flops.model_flops.cache_clear()
    embed.split_flops.cache_clear()


def test_a_small_cell_is_correct_and_its_control_is_not(tiny, small_vit,
                                                        monkeypatch):
    from harness import cell as cellmod

    run, spec = tiny
    embedded = []
    outputs_of = cellmod.outputs_of

    def recorded(peaks, out):
        embedded.append(int(out["embeddings_mask"].sum()))
        return outputs_of(peaks, out)

    monkeypatch.setattr(cellmod, "outputs_of", recorded)
    out, lines = run_tiny(run, spec, CELL, seconds=3.0)
    assert out["correct"], lines
    assert sum(embedded) > 0
    assert set(out["checks"]) == set(load(BENCH / "limits" / f"{CELL}.json"))
    assert "emb_cos_gap" in out["checks"]
    out, lines = run_tiny(run, spec, CELL, control=1)
    assert not out["correct"], lines
    assert out["checks"]["emb_cos_gap"]["value"] > out["checks"][
        "emb_cos_gap"]["limit"], lines


@pytest.mark.card
def test_the_cell_is_correct_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         str(2 ** 31 + 13), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
