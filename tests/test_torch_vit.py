"""The ViT face recognizer of insightface's arcface_torch
(``models/vit.py``), its converter and its place in the pipeline, on the
CPU at 2 blocks of width 64 with 8 heads of 8 (the published ViT-L's
144 tokens, 3 x 9 x 9 patches and 512-wide embedding).

Tolerances, each with its reason:

- float32 features within 1e-5 of their largest magnitude of the test
  oracle's (``torch_oracle.vit_forward``): the same float32 operations,
  summed in another order (a dense layer for the patch conv);
- bf16 features at one minus cosine below 2e-4: the dense layers round
  their operands and outputs to bf16 (2^-9 relative each), which leaves
  the features within about 2% of the float32 ones (a cosine gap near
  5e-5 at these weights); the float32 parts are checked by dtype;
- the attention core within 1e-5 relative of float64 attention on the
  same values: its float32 rounding (2^-24 relative each) summed over 144
  tokens; rounding the probabilities to bf16, as a bf16 core would, is
  held to fail that bound.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from terran_tpu_torch import pipeline as pipeline_module
from terran_tpu_torch.models import vit
from terran_tpu_torch.models.arcface import normalize_embeddings
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.runtime import PARAMS_KEEP_F32, cast_params_for_compute
from terran_tpu_torch.utils.convert import (
    CONVERTERS, convert_retinaface, convert_vit_l,
)
from terran_tpu_torch.utils.profiling import StageTimer
from torch_oracle import (
    random_retinaface_state_dict, random_vit_state_dict, vit_forward,
)
from test_torch_pipeline import StandInGraph
from torch_port_fixtures import single_torch_thread  # noqa: F401

HEADS = 8  # as published; the width shrinks to 64, so heads of 8
BENCH = Path(__file__).resolve().parents[1] / "portbench"
TINY = {"top_k": 16, "max_faces": 2, "max_escalations": 0,
        "det_short_side": 64}


@pytest.fixture(scope="module")
def state_dict():
    return random_vit_state_dict(np.random.default_rng(7))


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(8).integers(
        0, 256, size=(3, 112, 112, 3)).astype(np.float32)


def build(state_dict, dtype=torch.float32):
    params = cast_params_for_compute(convert_vit_l(state_dict), dtype,
                                     keep_f32=PARAMS_KEEP_F32["vit_l"])
    model = vit.ViTRecognizer.from_state_dict(params, dtype, heads=HEADS)
    model.load_state_dict(params, strict=True)
    return model.eval()


def oracle(state_dict, crops):
    return vit_forward(state_dict, np.transpose(crops, (0, 3, 1, 2)), HEADS)


def test_float32_matches_the_oracle(state_dict, crops):
    model = build(state_dict)
    with torch.inference_mode():
        got = model(torch.from_numpy(crops))
    want = oracle(state_dict, crops)
    assert got.shape == (3, 512) and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def test_bf16_keeps_the_float32_parts_and_the_features(state_dict, crops):
    model = build(state_dict, torch.bfloat16)
    block = model.blocks[0]
    for layer in (model.patch_embed, block.qkv, block.proj, block.fc1,
                  block.fc2, model.embed1, model.embed2):
        assert layer.weight.dtype == torch.bfloat16
    for param in (model.pos_embed, block.norm1.weight, block.norm2.bias,
                  model.norm.weight, model.bn1.weight, model.bn2.running_var):
        assert param.dtype == torch.float32
    with torch.inference_mode():
        got = model(torch.from_numpy(crops))
    want = oracle(state_dict, crops)
    assert got.dtype == torch.float32
    gap = 1.0 - F.cosine_similarity(got, want)
    assert float(gap.max()) < 2e-4, gap


def _attention64(q, k, v):
    scores = (q.double() @ k.double().transpose(-2, -1)) * q.shape[-1] ** -0.5
    return scores.softmax(-1) @ v.double()


def _rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


def test_attention_core_is_float32():
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn((2, 4, 144, 96), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    want = _attention64(q, k, v)
    got = vit.attention(q.float(), k.float(), v.float())
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    # A bf16 core: the probabilities rounded to bf16 before the product.
    scores = (q.float() @ k.float().transpose(-2, -1)) * 96 ** -0.5
    rounded = scores.softmax(-1).to(torch.bfloat16).float() @ v.float()
    assert _rel(rounded, want) > 1e-5


def test_a_bf16_block_feeds_the_core_float32(state_dict, monkeypatch):
    """The block upcasts the bf16 qkv output before the core, and the core
    it calls stays within the bound of float64 attention."""
    seen = []
    core = vit.attention

    def recording(q, k, v):
        seen.append((q, k, v))
        return core(q, k, v)

    model = build(state_dict, torch.bfloat16)
    monkeypatch.setattr(vit, "attention", recording)
    x = torch.randn((2, 144, 64), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        out = model.blocks[0](x)
    assert out.dtype == torch.float32
    (q, k, v), = seen
    assert q.dtype == k.dtype == v.dtype == torch.float32
    assert q.shape == (2, HEADS, 144, 64 // HEADS)
    assert _rel(recording(q, k, v), _attention64(q, k, v)) < 1e-5


def published_meta_state_dict():
    """arcface_torch's ViT-L state dict (vit_l_dp005_mask_005) on
    ``meta``: its key names and shapes."""
    dim, mlp, tokens = 768, 3072, 144
    shapes = {"patch_embed.proj.weight": (dim, 3, 9, 9),
              "patch_embed.proj.bias": (dim,),
              "pos_embed": (1, tokens, dim), "mask_token": (1, 1, dim)}
    for i in range(24):
        p = f"blocks.{i}"
        shapes.update({
            f"{p}.norm1.weight": (dim,), f"{p}.norm1.bias": (dim,),
            f"{p}.attn.qkv.weight": (3 * dim, dim),
            f"{p}.attn.proj.weight": (dim, dim),
            f"{p}.attn.proj.bias": (dim,),
            f"{p}.norm2.weight": (dim,), f"{p}.norm2.bias": (dim,),
            f"{p}.mlp.fc1.weight": (mlp, dim), f"{p}.mlp.fc1.bias": (mlp,),
            f"{p}.mlp.fc2.weight": (dim, mlp), f"{p}.mlp.fc2.bias": (dim,)})
    shapes.update({"norm.weight": (dim,), "norm.bias": (dim,),
                   "feature.0.weight": (dim, tokens * dim),
                   "feature.2.weight": (512, dim)})
    for bn, width in (("feature.1", dim), ("feature.3", 512)):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{bn}.{leaf}"] = (width,)
    sd = {key: torch.empty(shape, device="meta")
          for key, shape in shapes.items()}
    for bn in ("feature.1", "feature.3"):
        sd[f"{bn}.num_batches_tracked"] = torch.empty(
            (), dtype=torch.int64, device="meta")
    return sd


def test_convert_loads_the_published_vit_l_strictly():
    sd = published_meta_state_dict()
    params = convert_vit_l(sd)
    with torch.device("meta"):
        model = vit.ViTRecognizer.from_state_dict(params, torch.bfloat16)
    assert model.load_state_dict(params, strict=True)
    assert len(model.blocks) == 24 and model.grid == 12
    assert model.blocks[0].heads == 8
    assert tuple(model.blocks[0].fc1.weight.shape) == (3072, 768)
    assert tuple(model.embed1.weight.shape) == (768, 110592)
    assert sum(v.numel() for k, v in sd.items()
               if not k.endswith("tracked")) == 255_686_912
    assert CONVERTERS["vit_l"] is convert_vit_l
    extra = dict(sd, **{"blocks.0.attn.stray.weight": sd["norm.weight"]})
    with pytest.raises(ValueError, match="unconverted"):
        convert_vit_l(extra)


@pytest.fixture(scope="module")
def det_params():
    return convert_retinaface(
        random_retinaface_state_dict(np.random.default_rng(33)))


def make(det_params, state_dict, **kwargs):
    return PerceptionPipeline(
        det_params=det_params, rec_params=convert_vit_l(state_dict),
        recognizer="vit_l", with_pose=False, device="cpu",
        compute_dtype=torch.float32, **dict(TINY, **kwargs))


def frames_of(seed):
    return np.random.default_rng(seed).integers(0, 255, (2, 96, 128, 3),
                                                dtype=np.uint8)


def recorded_model_calls(pipe):
    calls = []
    pipe.rec_model.register_forward_hook(
        lambda module, args, out: calls.append((args[0].clone(), out)))
    return calls


@pytest.mark.parametrize("dispatch", ["adaptive", "fused"])
def test_pipeline_embeds_with_the_module(det_params, state_dict, dispatch):
    """The pipeline's embeddings are the module's features of the crops
    the pipeline fed it, normalised, in the slots of the kept faces."""
    pipe = make(det_params, state_dict, embed_dispatch=dispatch)
    assert isinstance(pipe.rec_model, vit.ViTRecognizer)
    calls = recorded_model_calls(pipe)
    out = pipe.process_batch(frames_of(14))
    valid = out["embeddings_mask"]
    assert valid.any()
    np.testing.assert_array_equal(valid, out["mask"][:, :2])
    (crops, _), = calls
    b, k = 2, crops.shape[0] // 2
    model = build(state_dict)
    with torch.inference_mode():
        want = normalize_embeddings(model(crops)).reshape(b, k, -1).numpy()
    got = out["embeddings"][:, :k]
    # The same module on the same crops: only the pipeline's masking and
    # packing lie between.
    np.testing.assert_allclose(got[valid[:, :k]], want[valid[:, :k]],
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out["embeddings"][~valid], 0.0)


@pytest.mark.parametrize("kwargs, match", [
    ({"embed_precision": "int8"}, "no int8 trunk"),
    ({"recognizer": "vit_b"}, "recognizer must be one of"),
])
def test_unsupported_recognizer_settings_raise(det_params, state_dict,
                                               kwargs, match):
    settings = dict(det_params=det_params,
                    rec_params=convert_vit_l(state_dict), recognizer="vit_l",
                    with_pose=False, device="cpu")
    with pytest.raises(ValueError, match=match):
        PerceptionPipeline(**dict(settings, **kwargs))


def test_vit_l_needs_its_weights(det_params):
    with pytest.raises(ValueError, match="needs rec_params"):
        PerceptionPipeline(det_params=det_params, recognizer="vit_l",
                           with_pose=False, device="cpu")


@pytest.mark.parametrize("dispatch", ["adaptive", "fused"])
def test_embed_records_only_with_a_timer(det_params, state_dict, dispatch):
    pipe = make(det_params, state_dict, embed_dispatch=dispatch)
    pipe.process_batch(frames_of(14))
    timer = pipe.timer = StageTimer()
    out = pipe.process_batch(frames_of(14))
    faces = int(out["embeddings_mask"].sum())
    assert faces > 0
    assert timer.counts["embed_device"] == 1
    assert timer.items["embed_device"] == faces
    assert timer.times["embed_device"] > 0.0
    pipe.timer = None
    pipe.process_batch(frames_of(14))
    assert timer.counts["embed_device"] == 1


def test_the_vit_pipelines_graphs_replay_its_eager_programs(
        det_params, state_dict, monkeypatch):
    """Under graphs_eligible the ViT's warp-embed programs are captured at
    each bucket and replayed, and a stream yields what the eager programs
    yield, bit for bit (``test_torch_pipeline``'s CPU stand-in for the
    CUDA graph's static buffers)."""

    monkeypatch.setattr(pipeline_module, "graphs_eligible",
                        lambda *settings: True)
    monkeypatch.setattr(pipeline_module, "_Graph", StandInGraph)
    pipe = make(det_params, state_dict)
    pipe.embed_buckets = [1]
    count = pipe.warmup(batch=2, height=96, width=128)
    assert count == 3 and len(pipe._graphs) == count  # detect, k=1, k=2
    batches = [frames_of(14 + i) for i in range(3)]
    got = list(pipe.process_stream(batches, depth=2))
    assert pipe.graph_calls["eager"] == 0
    assert pipe.graph_calls["replayed"] >= len(batches)
    pipe._graphs = {}
    want = list(pipe.process_stream(batches, depth=2))
    assert any(o["embeddings_mask"].any() for o in want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.fixture
def bench_reference(monkeypatch):
    """The benchmark's plain reference (``portbench/reference/vit_l.py``),
    imported from its folder and unloaded after the test."""
    def loaded():
        return [name for name in sys.modules
                if name == "reference" or name.startswith("reference.")]

    for name in loaded():
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(BENCH))
    yield importlib.import_module("reference.vit_l")
    for name in loaded():
        del sys.modules[name]


def test_the_benchmarks_reference_agrees_with_the_oracle(
        bench_reference, state_dict, crops):
    sd = {key: torch.as_tensor(np.asarray(value))
          for key, value in state_dict.items()}
    x = torch.from_numpy(np.transpose(crops, (0, 3, 1, 2)).copy())
    got = bench_reference.vit_l_forward(sd, x, heads=HEADS)
    want = oracle(state_dict, crops)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
