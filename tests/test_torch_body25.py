"""OpenPose's BODY_25 (``models/body25.py``), its converter and its place
in the pipeline (``PerceptionPipeline(pose='body25')``), on the CPU at
``torch_body25_weights``' narrow widths (the published 25 parts, 52 PAF
channels, stage order and dense blocks) with weights drawn from the
benchmark's plain reference's table, held to that reference
(``portbench/reference/body25.py``), loaded from its folder.

Tolerances, each with its reason:

- float32 outputs within 2e-5 of their largest magnitude of the
  reference's: the same float32 convolutions on the same values, in
  another memory layout (NHWC permuted against NCHW), ~110 convolutions
  on the deepest path (1.9e-6 to 4.6e-6 read at 4 seeds);
- bf16 outputs within 8% of the largest magnitude: every convolution
  rounds its operands and output to bf16 (2^-9 relative), through ~110
  convolutions whose weights keep the signal's scale (1.5-2.9% read at 4
  seeds); the reference with each convolution's operands rounded to fp8
  e4m3 (2^-4 relative) reads 23-40%, and is held to fail the bound;
- the pipeline's peak scores equal to the model's own heatmaps, upsampled
  on the CPU, bit for bit; against the reference's float32 heatmaps
  within 1e-5 of their largest magnitude (the model's 4.6e-6 above, and
  the x8 bicubic's float32 rounding).
"""

import numpy as np
import pytest
import torch

from terran_tpu_torch import pipeline as pipeline_module
from terran_tpu_torch.models import FAMILIES, POSE_FAMILIES, body25
from terran_tpu_torch.models import load_model
from terran_tpu_torch.ops.pose_decode import BODY_25
from terran_tpu_torch.ops.resize import resize_bilinear_u8, resized_shape
from terran_tpu_torch.ops.upsample import upsample_bicubic
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.utils.convert import (
    CONVERTERS, convert_body25, convert_openpose, convert_retinaface,
)
from terran_tpu_torch.utils.profiling import StageTimer
from torch_body25_weights import body25_state_dict, loaded_reference
from torch_oracle import (
    random_openpose_state_dict, random_retinaface_state_dict,
)
from test_torch_pipeline import StandInGraph
from torch_port_fixtures import single_torch_thread  # noqa: F401

TINY = {"top_k": 16, "max_faces": 2, "max_escalations": 0,
        "det_short_side": 64, "pose_short_side": 64, "max_peaks": 4}


@pytest.fixture(scope="module")
def state_dict():
    return {key: torch.as_tensor(value) for key, value in
            body25_state_dict(np.random.default_rng(0)).items()}


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(100).integers(
        0, 256, size=(2, 64, 96, 3)).astype(np.uint8)


@pytest.fixture
def reference():
    """The benchmark's plain reference (``portbench/reference/
    body25.py``), imported from its folder and unloaded after the test."""
    with loaded_reference() as module:
        yield module


def run_reference(reference, state_dict, frames, ops=None):
    """The reference's (N, 78, h, w) output on uint8 RGB frames: BGR,
    ``x / 256 - 0.5``."""
    x = torch.from_numpy(frames).flip(-1).permute(0, 3, 1, 2).float()
    args = () if ops is None else (ops,)
    return reference.body25_forward(state_dict, x / 256.0 - 0.5, *args)


def run_port(state_dict, frames, dtype=torch.float32):
    model = load_model("body25", convert_body25(state_dict), dtype, "cpu")
    x = torch.from_numpy(frames).float() / model.input_scale - 0.5
    with torch.inference_mode():
        pafs, heatmaps = model(x.to(dtype))
    return torch.cat([heatmaps, pafs], dim=-1).float().permute(0, 3, 1, 2)


def test_float32_matches_the_reference(reference, state_dict, frames):
    want = run_reference(reference, state_dict, frames)
    got = run_port(state_dict, frames)
    assert got.shape == want.shape == (2, 78, 8, 12)
    err = float((got - want).abs().max())
    assert err <= 2e-5 * float(want.abs().max()), err


def test_bf16_holds_the_reference_and_fp8_does_not(reference, state_dict,
                                                   frames):
    from reference.models import Quantized

    want = run_reference(reference, state_dict, frames)
    scale = float(want.abs().max())
    got = run_port(state_dict, frames, torch.bfloat16)
    assert float((got - want).abs().max()) <= 0.08 * scale
    fp8 = run_reference(reference, state_dict, frames, Quantized("fp8"))
    assert float((fp8 - want).abs().max()) > 0.08 * scale


def test_convert_loads_the_published_body25_strictly(reference):
    sd = {key: torch.empty(shape, device="meta")
          for key, shape, _ in reference.body25_specs()}
    params = convert_body25(sd)
    assert params.keys() == sd.keys()
    with torch.device("meta"):
        model = body25.Body25Model.from_state_dict(params, torch.bfloat16)
    assert model.load_state_dict(params, strict=True)
    assert sum(v.numel() for v in sd.values()) == 26_166_084
    assert tuple(model.Mconv1_stage0_L2_0.weight.shape) == (96, 128, 3, 3)
    assert tuple(model.Mconv1_stage1_L1_0.weight.shape) == (128, 206, 3, 3)
    assert tuple(model.Mconv7_stage3_L2.weight.shape) == (52, 512, 1, 1)
    assert tuple(model.prelu4_2.weight.shape) == (512,)
    assert CONVERTERS["body25"] is convert_body25
    extra = dict(sd, **{"Mconv8_stage0_L2.weight": sd["conv1_1.bias"]})
    with pytest.raises(ValueError, match="unconverted"):
        convert_body25(extra)
    missing = {k: v for k, v in sd.items() if k != "Mprelu6_stage1_L1.weight"}
    with pytest.raises(KeyError):
        convert_body25(missing)


def test_convert_flips_only_the_first_convs_input_channels(state_dict):
    params = convert_body25(state_dict)
    torch.testing.assert_close(params["conv1_1.weight"],
                               state_dict["conv1_1.weight"].flip(1),
                               rtol=0, atol=0)
    for key in state_dict:
        if key != "conv1_1.weight":
            assert torch.equal(params[key], state_dict[key]), key


def test_the_family_is_registered():
    assert POSE_FAMILIES == ("openpose", "body25")
    entry = FAMILIES["body25"]
    assert entry.skeleton is BODY_25
    assert entry.int8 is None and entry.checkpoint is None


@pytest.fixture(scope="module")
def det_params():
    return convert_retinaface(
        random_retinaface_state_dict(np.random.default_rng(33)))


def make(det_params, state_dict, **kwargs):
    return PerceptionPipeline(
        det_params=det_params, pose_params=convert_body25(state_dict),
        pose="body25", with_embeddings=False, device="cpu",
        compute_dtype=torch.float32, **dict(TINY, **kwargs))


def frames_of(seed):
    return np.random.default_rng(seed).integers(0, 255, (2, 96, 128, 3),
                                                dtype=np.uint8)


def recorded_tables(monkeypatch):
    """The (coords, scores, valid) tables and the skeleton that the
    pipeline hands its assembly, frame by frame."""
    tables = []
    original = pipeline_module.assemble_humans

    def recording(coords, scores, valid, *args, **kwargs):
        tables.append((coords, scores, valid, kwargs.get("skeleton")))
        return original(coords, scores, valid, *args, **kwargs)

    monkeypatch.setattr(pipeline_module, "assemble_humans", recording)
    return tables


@pytest.mark.parametrize("limbs", ["adaptive", "fused"])
def test_the_pipeline_streams_body25_peaks(det_params, state_dict,
                                           monkeypatch, reference, limbs):
    """Through ``process_stream`` the pipeline finds the 25 parts' peaks
    of BODY_25's heatmaps at its pose resize, hands them to the assembly
    with BODY_25's skeleton, and yields poses of 25 keypoints."""
    pipe = make(det_params, state_dict, limb_dispatch=limbs)
    assert isinstance(pipe.pose_model, body25.Body25Model)
    assert pipe.skeleton is BODY_25
    tables = recorded_tables(monkeypatch)
    batches = [frames_of(20 + i) for i in range(3)]
    outs = list(pipe.process_stream(batches, depth=2))
    assert len(outs) == 3 and len(tables) == 6
    ph, pw, _ = resized_shape(96, 128, TINY["pose_short_side"])
    found = 0
    for batch, out in zip(batches, outs):
        assert len(out["poses"]) == 2
        for poses in out["poses"]:
            assert all(p["keypoints"].shape == (25, 3) for p in poses)
        resized = resize_bilinear_u8(torch.from_numpy(batch), ph, pw)
        x = resized.float() / 256.0 - 0.5
        with torch.inference_mode():
            heat = upsample_bicubic(
                pipe.pose_model(x)[1][..., :25], 8).movedim(-1, 1)
        want = reference.heatmaps(state_dict, torch.from_numpy(batch),
                                  TINY["pose_short_side"])
        for i in range(2):
            coords, scores, valid, skeleton = tables.pop(0)
            assert skeleton is BODY_25
            assert coords.shape[:2] == scores.shape[:2] == (25, 4)
            p, k = np.nonzero(valid)
            found += len(p)
            y, x_ = coords[p, k, 0], coords[p, k, 1]
            np.testing.assert_array_equal(scores[p, k], heat[i, p, y, x_])
            gap = np.abs(scores[p, k] - want[i, p, y, x_].numpy())
            assert gap.max(initial=0) <= 1e-5 * float(want.abs().max())
            assert (scores[p, k] >= 0.1).all()
    assert found > 0


@pytest.mark.parametrize("kwargs, match", [
    ({"pose_precision": "int8"}, "no int8 trunk"),
    ({"pose": "body_135"}, "pose must be one of"),
])
def test_unsupported_pose_settings_raise(det_params, state_dict, kwargs,
                                         match):
    settings = dict(det_params=det_params,
                    pose_params=convert_body25(state_dict), pose="body25",
                    with_embeddings=False, device="cpu")
    with pytest.raises(ValueError, match=match):
        PerceptionPipeline(**dict(settings, **kwargs))


def test_body25_needs_its_weights(det_params):
    with pytest.raises(ValueError, match="needs pose_params"):
        PerceptionPipeline(det_params=det_params, pose="body25",
                           with_embeddings=False, device="cpu")


@pytest.mark.parametrize("family", ["openpose", "body25"])
@pytest.mark.parametrize("limbs", ["adaptive", "fused"])
def test_pose_records_only_with_a_timer(det_params, state_dict, family,
                                        limbs):
    """One ``pose_device`` record a call of the pose program, items the
    batch's frames, only with a timer attached."""
    params = (convert_body25(state_dict) if family == "body25" else
              convert_openpose(random_openpose_state_dict(
                  np.random.default_rng(2))))
    pipe = PerceptionPipeline(
        det_params=det_params, pose_params=params, pose=family,
        with_embeddings=False, device="cpu", compute_dtype=torch.float32,
        limb_dispatch=limbs, **TINY)
    pipe.process_batch(frames_of(14))
    timer = pipe.timer = StageTimer()
    pipe.process_batch(frames_of(14))
    list(pipe.process_stream([frames_of(15), frames_of(16)], depth=2))
    assert timer.counts["pose_device"] == 3
    assert timer.items["pose_device"] == 6
    assert timer.times["pose_device"] > 0.0
    pipe.timer = None
    pipe.process_batch(frames_of(14))
    assert timer.counts["pose_device"] == 3


def test_the_body25_pipelines_graphs_replay_its_eager_programs(
        det_params, state_dict, monkeypatch):
    """Under graphs_eligible BODY_25's pose programs are captured at each
    limb bucket and replayed, and a stream yields what the eager programs
    yield, bit for bit (``test_torch_pipeline``'s CPU stand-in for the
    CUDA graph's static buffers)."""
    monkeypatch.setattr(pipeline_module, "graphs_eligible",
                        lambda *settings: True)
    monkeypatch.setattr(pipeline_module, "_Graph", StandInGraph)
    pipe = make(det_params, state_dict)
    pipe.peak_buckets = [2]
    count = pipe.warmup(batch=2, height=96, width=128)
    # detect, pose, the limbs at kb = 2 and 4
    assert count == 4 and len(pipe._graphs) == count
    batches = [frames_of(30 + i) for i in range(3)]
    got = list(pipe.process_stream(batches, depth=2))
    assert pipe.graph_calls["eager"] == 0
    assert pipe.graph_calls["replayed"] >= 3 * len(batches)
    pipe._graphs = {}
    want = list(pipe.process_stream(batches, depth=2))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            if key == "poses":
                assert len(g[key]) == len(w[key])
                for a, b in zip(g[key], w[key]):
                    assert len(a) == len(b)
                    for pa, pb in zip(a, b):
                        np.testing.assert_array_equal(pa["keypoints"],
                                                      pb["keypoints"])
                        assert pa["score"] == pb["score"]
            else:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
