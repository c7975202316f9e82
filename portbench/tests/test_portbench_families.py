"""A configuration's families decide what the harness draws, judges,
builds and counts, each found by the name of its binding: the three
committed families exactly as before, a toy recognizer added as files
alone, and a configuration without a pose model run whole."""

import copy
import hashlib
import json
import re
import shutil

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, load, run_tiny
from harness import families, flops, weights
from harness.spec import validate

TOY = BENCH / "tests" / "toy"
OLD_ORDER = ("retinaface", "arcface", "openpose")
# sha256 over each key and its tensor's bytes of the families' draws at
# the committed configurations' weights_seed 4 on the CPU, recorded
# before families were found by name.
PARENT_DRAWS = {
    "retinaface":
        "76141bfdc0da8818e9cacc6c6736fc477a969e81972c7c19d750cc3dc19b395c",
    "arcface":
        "fc649d0d73d43afb71e272e7d4fb2943b50c2be9bb94cca704f5a3dadc650526",
    "openpose":
        "dd0c851311ce5d7b4031123a82e9ef77e8ef1332fb1fc27c2e8c8307d03c5013",
}
# The files that may name no family: the harness outside the bindings.
GENERIC = ["harness/weights.py", "harness/judge.py", "run.py",
           "harness/cell.py", "harness/flops.py", "harness/layers.py"]


@pytest.fixture
def spec():
    return copy.deepcopy(load(ROOT / "BENCHMARK.json"))


@pytest.mark.parametrize("seed", [0, 4, 2 ** 31 + 11, 2 ** 62 + 5])
def test_the_first_families_keep_their_seeds(seed):
    for index, name in enumerate(OLD_ORDER):
        assert weights.family_seed(seed, name) == (seed * 3 + index) % 2 ** 63


def test_a_new_familys_seed_differs_from_the_first_three():
    for path in (BENCH / "configs").glob("*.json"):
        seed = load(path)["weights_seed"]
        taken = {weights.family_seed(seed, n) for n in OLD_ORDER}
        for name in ("vit_l", "toyrec", "scrfd"):
            assert weights.family_seed(seed, name) not in taken
            assert weights.family_seed(seed, name) == weights.family_seed(
                seed, name)


@pytest.mark.parametrize("family", OLD_ORDER)
def test_the_first_families_draw_as_before(family):
    seeds = {load(p)["weights_seed"] for p in (BENCH / "configs").glob(
        "*.json")}
    assert seeds == {4}
    sd = weights.make_state_dict(family, 4, "cpu")
    digest = hashlib.sha256()
    for key, value in sd.items():
        digest.update(key.encode())
        digest.update(value.contiguous().numpy().tobytes())
    assert digest.hexdigest() == PARENT_DRAWS[family]


def test_only_the_bindings_and_the_seed_table_name_a_family():
    names = re.compile("|".join(OLD_ORDER), re.IGNORECASE)
    for rel in GENERIC:
        for number, line in enumerate((BENCH / rel).read_text().splitlines()):
            if names.search(line):
                assert rel == "harness/weights.py" and re.match(
                    r'LEGACY = \{"retinaface": 0, "arcface": 1, '
                    r'"openpose": 2\}$', line), (rel, number + 1, line)


@pytest.mark.parametrize("config", ["terran-bf16", "terran-int8"])
def test_the_pipelines_keywords_are_the_ones_it_was_built_with(
        spec, monkeypatch, config):
    """Each binding hands its own state dict to its own converter, and
    the settings follow as they did; the two role switches are on, as
    the pipeline's defaults were."""
    import inspect

    import terran_tpu_torch.pipeline as program
    import terran_tpu_torch.utils.convert as convert
    from harness import cell as cellmod

    real = inspect.signature(program.PerceptionPipeline).parameters
    for name in OLD_ORDER:
        monkeypatch.setattr(convert, f"convert_{name}",
                            lambda sd, name=name: (name, sd))

    class Stub:
        def __init__(self, **kwargs):
            self.kwargs = kwargs

    monkeypatch.setattr(program, "PerceptionPipeline", Stub)
    workload = next(w["name"] for w in spec["workloads"]
                    if w["config"] == config)
    cell = cellmod.Cell(workload, spec)
    w = {name: object() for name in OLD_ORDER}
    got = cellmod.build_pipeline(cell, w, torch.device("cpu")).kwargs
    c = cell.pipe_cfg
    before = dict(
        det_params=("retinaface", w["retinaface"]),
        rec_params=("arcface", w["arcface"]),
        pose_params=("openpose", w["openpose"]),
        det_short_side=c["det_short_side"],
        pose_short_side=c["pose_short_side"], threshold=c["threshold"],
        nms_threshold=c["nms_threshold"], top_k=c["top_k"],
        max_faces=c["max_faces"], max_peaks=c["max_peaks"],
        max_escalations=c["max_escalations"],
        compute_dtype=getattr(torch, c["compute_dtype"]),
        embed_dispatch=c["embed_dispatch"], limb_dispatch=c["limb_dispatch"],
        transfer_plan=c["transfer_plan"],
        embed_precision=c["embed_precision"],
        pose_precision=c["pose_precision"], device=torch.device("cpu"))
    switches = {k: got.pop(k) for k in ("with_pose", "with_embeddings")}
    assert switches == {k: real[k].default for k in switches} == {
        "with_pose": True, "with_embeddings": True}
    assert got.keys() == before.keys()
    for key, value in before.items():
        assert got[key] == value, key


def test_quantized_matmul_rounds_both_operands_per_tensor():
    from reference.models import FLOAT, Quantized

    a = torch.tensor([[1.4, -3.0], [2.6, 7.0]])
    b = torch.tensor([[0.5, 1.0], [-3.5, 0.24]])
    assert torch.equal(FLOAT.matmul(a, b), a @ b)
    # int4, 7 levels: a's scale 7 / 7 = 1 rounds it to [[1, -3], [3, 7]];
    # b's 3.5 / 7 = 0.5 rounds b / 0.5 = [[1, 2], [-7, 0.48]] to [[1, 2],
    # [-7, 0]]; the product [[22, 2], [-46, 6]] times 1 x 0.5.
    want = torch.tensor([[11.0, 1.0], [-23.0, 3.0]])
    got = Quantized("int4").matmul(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    # Batched: each matrix of the batch shares the tensor's one scale.
    stacked = Quantized("int4").matmul(torch.stack([a, a]),
                                       torch.stack([b, b]))
    assert torch.equal(stacked, torch.stack([want] * 2))


def test_the_counting_matmul_counts_each_product():
    ops = flops._Counting()
    y = ops.matmul(torch.empty((2, 3, 4, 5), device="meta"),
                   torch.empty((2, 3, 5, 6), device="meta"))
    assert tuple(y.shape) == (2, 3, 4, 6)
    assert ops.flops == 2 * (2 * 3) * 4 * 5 * 6


def _write_config(bench, spec, name, models, control=None):
    """A configuration of terran-bf16's pipeline with the given families,
    as a new file named in the spec."""
    cfg = load(bench / "configs" / "terran-bf16.json")
    base = cfg["models"]
    cfg["name"] = name
    cfg["models"] = {m: base.get(m, {"paper": "a test"}) for m in models}
    cfg["control"] = control or {m: "fp8" for m in models}
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    spec["configs"].append(dict(spec["configs"][0], name=name,
                                file=f"portbench/configs/{name}.json"))
    return cfg


@pytest.mark.parametrize("models, control, message", [
    (["retinaface", "scrfd"], None, "no binding families/scrfd.py"),
    (["retinaface", "arcface", "retinaface_copy"], None,
     "both a detector"),
    (["arcface", "openpose"], None, "no detector"),
    (["retinaface", "arcface"], {"retinaface": "fp8"},
     "no control precision for ['arcface']"),
    (["retinaface", "bad name"], None, "bad family name"),
])
def test_a_configurations_families_are_checked(tiny, models, control,
                                               message):
    run, spec = tiny
    bench = run.BENCH
    shutil.copy(bench / "families" / "retinaface.py",
                bench / "families" / "retinaface_copy.py")
    _write_config(bench, spec, "checked", models, control)
    with pytest.raises(ValueError, match=re.escape(message)):
        validate(spec, bench, bench.parent)


def test_a_toy_recognizer_is_added_by_files_alone(tiny):
    """Its binding and its reference as new files: the spec validates,
    its weights draw, the reference embeds with it and judges a perturbed
    embedding far off and its own at 0, and the count sees its product
    of two activations, with no file of the benchmark edited."""
    from harness import judge as J
    from harness.cell import Cell, make_frames

    run, spec = tiny
    bench = run.BENCH
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    for rel in ("families/toyrec.py", "reference/toyrec.py"):
        shutil.copy(TOY / rel, bench / rel)
    cfg = _write_config(bench, spec, "toy", ["retinaface", "toyrec"])
    spec["workloads"].append({"name": "toy-offline", "config": "toy",
                              "traffic": "offline-1080p", "chips": 1,
                              "why": "a test"})
    (bench / "limits" / "toy-offline.json").write_text(
        (bench / "limits" / "bf16-offline-1080p.json").read_text())
    validate(spec, bench, bench.parent)
    cell = Cell("toy-offline", spec)
    assert {r: f.name for r, f in cell.families.items()} == {
        "detector": "retinaface", "recognizer": "toyrec"}

    w = weights.make_weights(cfg["weights_seed"], "cpu", cfg["models"])
    assert set(w) == {"retinaface", "toyrec"}
    assert tuple(w["toyrec"]["head.weight"].shape) == (8, 256)
    assert flops.model_flops("toyrec", 112, 112) == (
        2 * 4 * 16 * 3 + 2 * 16 * 4 * 16 + 2 * 8 * 256)
    h, wd = cell.mix["frame"]
    assert flops.frame_flops(cell.families, h, wd, cell.pipe_cfg)[
        "toyrec"] == flops.model_flops("toyrec", 112, 112)

    frames = torch.as_tensor(make_frames(3, 2, h, wd, "cpu"))
    reference = J.Reference(w, cell.pipe_cfg, cell.families)
    own = reference.as_program(frames)
    assert own[0]["embeddings"].shape == (cell.pipe_cfg["max_faces"], 8)
    assert any(o["embeddings_mask"].any() for o in own)
    assert all(o["peaks"] is None for o in own)
    numbers = J.compare_frames(reference, frames, own, {})
    assert "peak_score_gap" not in numbers
    assert numbers["emb_cos_gap"] < 1e-6
    perturbed = [dict(o, embeddings=np.roll(o["embeddings"], 1, axis=-1))
                 for o in own]
    assert J.compare_frames(reference, frames, perturbed,
                            {})["emb_cos_gap"] > 0.1
    edited = [p for p, data in before.items() if p.read_bytes() != data]
    assert not edited


def _faces_only(run, spec):
    """A configuration of the detector and the recognizer alone, with its
    offline cell and limits (the bf16 cell's, less the peak numbers), as
    new files."""
    bench = run.BENCH
    _write_config(bench, spec, "faces-only", ["retinaface", "arcface"])
    limits = load(bench / "limits" / "bf16-offline-1080p.json")
    limits = {k: v for k, v in limits.items()
              if k not in run.PEAKS_UNRECORDED}
    (bench / "limits" / "faces-only-offline.json").write_text(
        json.dumps(limits))
    spec["workloads"].append({"name": "faces-only-offline",
                              "config": "faces-only",
                              "traffic": "offline-1080p", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("faces-only-offline")
    return set(limits)


def test_a_configuration_without_pose_runs_a_whole_cell(tiny, monkeypatch):
    from harness import cell as cellmod

    run, spec = tiny
    compared = _faces_only(run, spec)
    built = []
    kwargs_of = cellmod.pipeline_kwargs

    def recorded(*args):
        built.append(kwargs_of(*args))
        return built[-1]

    monkeypatch.setattr(cellmod, "pipeline_kwargs", recorded)
    out, lines = run_tiny(run, spec, "faces-only-offline", seconds=6.0)
    assert out["correct"], lines
    assert built and built[0]["with_pose"] is False
    assert built[0]["with_embeddings"] is True
    assert "pose_params" not in built[0]
    assert set(out["checks"]) == compared
    assert not set(run.PEAKS_UNRECORDED) & set(out["checks"])
    assert out["extra"]["not_compared"] == []
    assert not [line for line in lines if "not compared" in line]
    assert out["attempted"] > 0


def test_a_configuration_without_pose_fails_its_control(tiny):
    run, spec = tiny
    _faces_only(run, spec)
    out, lines = run_tiny(run, spec, "faces-only-offline", control=1)
    assert not out["correct"], lines
    assert [n for n, c in out["checks"].items() if c["value"] > c["limit"]]


def test_families_are_listed_in_role_order(spec):
    from harness.cell import Cell

    cell = Cell("bf16-offline-1080p", spec)
    assert list(cell.families) == list(families.ROLES)
    assert [f.name for f in cell.families.values()] == [
        "retinaface", "openpose", "arcface"]
