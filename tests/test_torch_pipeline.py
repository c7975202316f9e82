"""Port's PerceptionPipeline vs the JAX package's, float32 on the CPU.

Against ``terran_tpu.pipeline.PerceptionPipeline`` on the same weights
(``tests/test_pipeline.py``'s tiny configuration: weights from
``default_rng(33)``, top_k 16, max_faces 4, max_peaks 8, no escalation),
at two frame shapes whose resizes are exact in both packages: (2, 96,
128, 3) at det and pose short side 96 (the identity), and (2, 128, 192,
3) at det 64 and pose 32 (x1/2 and x1/4). The second runs with the pose
thresholds lowered so that random weights assemble humans. Tolerances:

- ``mask``, ``det_overflow``, ``pose_overflow`` and ``embeddings_mask``
  equal;
- int32 ``boxes`` and ``landmarks`` of kept faces within one count: the
  float32 heads differ by summation order (about 1e-5 relative), which
  can move a coordinate across a rounding boundary;
- kept ``scores`` within 1e-5;
- embeddings of valid slots at cosine > 0.999 (host float64 alignment,
  then float32 through 100 layers), zero elsewhere in both;
- pose keypoints equal, human for human.

The rest holds the port to itself, as ``tests/test_pipeline.py`` holds the
JAX class: stream against batch, adaptive against fused, buckets,
escalation, warmup and the parts not ported. These run a cheaper
configuration (det short side 64, pose 48, fewer face slots), since the
CPU's FaceResNet100 costs ~0.3 s a crop on one thread.
"""

import dataclasses
import sys
import threading
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terran_tpu.ops.warp import alignment_matrices_jax
from terran_tpu.pipeline import PerceptionPipeline as JaxPipeline
from terran_tpu.utils.convert import convert_arcface as jax_convert_arcface
from terran_tpu.utils.convert import convert_openpose as jax_convert_openpose
from terran_tpu.utils.convert import (
    convert_retinaface as jax_convert_retinaface,
)
from terran_tpu_torch.config import get_config, set_config
from terran_tpu_torch.io import (
    device_prefetch, fixed_shape_batches, threaded_device_put,
)
from terran_tpu_torch.models.retinaface import anchor_cell_meta
from terran_tpu_torch.ops.resize import resized_shape
from terran_tpu_torch.ops.warp import (
    ARCFACE_TEMPLATE, alignment_matrices, alignment_matrices_torch,
    warp_affine_batch, warp_affine_frames,
)
from terran_tpu_torch import pipeline as pipeline_module
from terran_tpu_torch.pipeline import PerceptionPipeline, graphs_eligible
from terran_tpu_torch.utils.convert import (
    convert_arcface, convert_openpose, convert_retinaface,
)
from terran_tpu_torch.utils.profiling import StageTimer, Timeline
from torch_oracle import (
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict,
)
from torch_port_fixtures import single_torch_thread  # noqa: F401

TINY = {"top_k": 16, "max_faces": 4, "max_peaks": 8, "max_escalations": 0}
LOWERED_POSE_THRESHOLDS = {"keypoint_threshold": -1e9,
                           "thresh_midpoint": -1e9, "human_threshold": -1e9}


@pytest.fixture(scope="module")
def state_dicts():
    rng = np.random.default_rng(33)
    return (random_retinaface_state_dict(rng),
            random_arcface_state_dict(rng),
            random_openpose_state_dict(rng))


@pytest.fixture(scope="module")
def jax_params(state_dicts):
    det, rec, pose = state_dicts
    return (jax_convert_retinaface(det), jax_convert_arcface(rec),
            jax_convert_openpose(pose))


@pytest.fixture(scope="module")
def params(state_dicts):
    det, rec, pose = state_dicts
    return (convert_retinaface(det), convert_arcface(rec),
            convert_openpose(pose))


def make(params, **kwargs):
    """A CPU pipeline in the cheap test configuration."""
    det, rec, pose = params
    config = dict(TINY, det_short_side=64, pose_short_side=48)
    config.update(kwargs)
    # Only the models a configuration runs are loaded.
    return PerceptionPipeline(
        det_params=det, rec_params=rec if config.get("with_embeddings", True)
        else None, pose_params=pose if config.get("with_pose", True) else None,
        device="cpu", **config)


def program_kinds(pipe):
    """The kinds of device program the pipeline built."""
    return {kind for kind, _ in pipe._programs}


def frames_of(seed, shape=(2, 96, 128, 3)):
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


def assert_same_poses(got, expected):
    assert len(got) == len(expected)
    for a, b in zip(got, expected):
        assert len(a) == len(b)
        for ha, hb in zip(a, b):
            np.testing.assert_array_equal(ha["keypoints"], hb["keypoints"])
            np.testing.assert_allclose(ha["score"], hb["score"], atol=1e-5)


def assert_same_results(got, expected):
    """Two runs of the port on the same inputs: every output equal."""
    for key in ("boxes", "landmarks", "scores", "mask", "det_overflow",
                "embeddings", "embeddings_mask", "pose_overflow"):
        np.testing.assert_array_equal(got[key], expected[key], err_msg=key)
    assert_same_poses(got["poses"], expected["poses"])


# ---------------------------------------------------------------------------
# Against the JAX pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,det_side,pose_side,lowered", [
    ((96, 128), 96, 96, False),
    ((128, 192), 64, 32, True),
])
def test_pipeline_matches_jax(jax_params, shape, det_side, pose_side,
                              lowered):
    config = dict(TINY, det_short_side=det_side, pose_short_side=pose_side)
    jax_pipe = JaxPipeline(*jax_params, **config)
    # The port takes the JAX class's param pytrees as they are.
    port = PerceptionPipeline(*jax_params, device="cpu", **config)
    for pipe in (jax_pipe, port):
        for name, value in (LOWERED_POSE_THRESHOLDS.items() if lowered
                            else ()):
            setattr(pipe, name, value)
    for side in (det_side, pose_side):  # both resizes exact
        out_h, out_w, scale = resized_shape(*shape, side)
        assert (out_h, out_w) == (shape[0] * scale, shape[1] * scale)
        assert scale in (1.0, 0.5, 0.25)

    frames = frames_of(5, (2,) + shape + (3,))
    exp = jax_pipe.process_batch(frames)
    got = port.process_batch(frames)

    assert got.keys() == exp.keys()
    for key in ("mask", "det_overflow", "pose_overflow", "embeddings_mask"):
        np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
    mask = exp["mask"]
    assert mask.any(), "no faces to compare"
    for key in ("boxes", "landmarks"):
        assert got[key].dtype == np.int32 and got[key].shape == exp[key].shape
        assert np.abs(got[key][mask] - exp[key][mask]).max() <= 1, key
    np.testing.assert_allclose(got["scores"][mask], exp["scores"][mask],
                               rtol=0, atol=1e-5)

    valid = exp["embeddings_mask"]
    assert valid.any(), "no embeddings to compare"
    assert got["embeddings"].shape == exp["embeddings"].shape
    cos = (got["embeddings"][valid] * exp["embeddings"][valid]).sum(-1)
    assert (cos > 0.999).all(), cos.min()
    np.testing.assert_array_equal(got["embeddings"][~valid], 0.0)
    np.testing.assert_array_equal(exp["embeddings"][~valid], 0.0)

    assert_same_poses(got["poses"], exp["poses"])
    if lowered:
        assert sum(map(len, exp["poses"])) > 0, "no humans to compare"
    faces = port.faces_from(got)
    assert [len(f) for f in faces] == list(mask.sum(axis=1))


@pytest.mark.parametrize("det_shape", [(96, 128), (64, 96), (416, 739)])
def test_valid_cell_mask_is_all_true_unpadded(det_shape):
    """The pipeline runs the detect step at its own unpadded det shape, so
    the valid-cell mask of ``make_detect_fn`` keeps every anchor, as the
    JAX pipeline, which has no such mask, does."""
    h, w = det_shape
    cell_x, cell_y, stride = anchor_cell_meta(h, w)
    assert (cell_x < (w + stride - 1) // stride).all()
    assert (cell_y < (h + stride - 1) // stride).all()


def test_alignment_matrices_torch_matches_jax_and_host():
    rng = np.random.default_rng(7)
    lmks = rng.uniform(10, 200, size=(6, 5, 2)).astype(np.float32)
    lmks[0] = ARCFACE_TEMPLATE * 1.7 + (30, 40)
    lmks[1] = lmks[0] * (-1, 1) + (300, 0)  # mirrored: det(cov) < 0
    got = alignment_matrices_torch(torch.from_numpy(lmks)).numpy()
    assert got.shape == (6, 2, 3) and got.dtype == np.float32
    jax_got = np.asarray(alignment_matrices_jax(jnp.asarray(lmks)))
    np.testing.assert_allclose(got, jax_got, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, alignment_matrices(lmks), rtol=1e-3,
                               atol=1e-2)
    batched = alignment_matrices_torch(
        torch.from_numpy(lmks.reshape(2, 3, 5, 2))).numpy()
    np.testing.assert_array_equal(batched.reshape(6, 2, 3), got)


@pytest.mark.parametrize("size", [(40, 56), (1, 1)])
def test_warp_affine_frames_matches_per_frame_warp(size):
    rng = np.random.default_rng(8)
    frames = torch.from_numpy(
        rng.integers(0, 255, (3,) + size + (3,), dtype=np.uint8))
    lmks = rng.uniform(-10, 70, size=(3, 4, 5, 2)).astype(np.float32)
    mats = torch.from_numpy(alignment_matrices(lmks.reshape(-1, 5, 2))
                            ).reshape(3, 4, 2, 3)
    got = warp_affine_frames(frames, mats, out_h=24, out_w=20)
    assert got.shape == (3, 4, 24, 20, 3) and got.dtype == torch.float32
    for b in range(3):
        assert torch.equal(got[b], warp_affine_batch(frames[b], mats[b],
                                                     out_h=24, out_w=20))


# ---------------------------------------------------------------------------
# The port against itself
# ---------------------------------------------------------------------------

def test_process_stream_matches_process_batch(params):
    timer = StageTimer()
    pipe = make(params, max_faces=1, timer=timer)
    pipe.timeline = Timeline()
    batches = [frames_of(seed) for seed in (11, 12, 13)]
    streamed = list(pipe.process_stream(batches, depth=2))
    assert len(streamed) == 3
    events = {row[1] for row in pipe.timeline.rows()}
    assert {"h2d_thread", "perception_step", "det_fetch", "embed_dispatch",
            "limb_fetch", "pose_assembly"} <= events
    summary = timer.summary()
    assert summary["perception_step"]["calls"] == 3
    assert pipe.upload_bytes >= sum(b.nbytes for b in batches)
    pipe.timeline = None
    for frames, out in zip(batches, streamed):
        assert_same_results(out, pipe.process_batch(frames))


@pytest.fixture(scope="module")
def adaptive_and_fused(params):
    frames = frames_of(14)
    outs = []
    for mode in ("adaptive", "fused"):
        pipe = make(params, max_faces=2, embed_dispatch=mode,
                    limb_dispatch=mode)
        for name, value in LOWERED_POSE_THRESHOLDS.items():
            setattr(pipe, name, value)
        outs.append(pipe.process_batch(frames))
    return outs


def test_adaptive_embed_matches_fused(adaptive_and_fused):
    out_a, out_f = adaptive_and_fused
    np.testing.assert_array_equal(out_a["mask"], out_f["mask"])
    np.testing.assert_array_equal(out_a["embeddings_mask"],
                                  out_f["embeddings_mask"])
    assert out_a["embeddings"].shape == out_f["embeddings"].shape
    valid = out_a["embeddings_mask"]
    assert valid.any()
    cos = (out_a["embeddings"][valid] * out_f["embeddings"][valid]).sum(-1)
    assert (cos > 0.999).all(), cos.min()
    np.testing.assert_array_equal(out_a["embeddings"][~valid], 0.0)
    np.testing.assert_array_equal(out_f["embeddings"][~valid], 0.0)


def test_adaptive_limbs_match_fused(adaptive_and_fused):
    out_a, out_f = adaptive_and_fused
    np.testing.assert_array_equal(out_a["pose_overflow"],
                                  out_f["pose_overflow"])
    assert sum(map(len, out_a["poses"])) > 0
    assert_same_poses(out_a["poses"], out_f["poses"])


def test_no_faces_builds_no_embed_program(params):
    pipe = make(params, with_pose=False)
    pipe.threshold = 2.0  # nothing can clear it
    out = pipe.process_batch(frames_of(15))
    assert not out["mask"].any()
    np.testing.assert_array_equal(out["embeddings"], 0.0)
    assert out["embeddings"].shape == (2, 4, 512)
    assert not out["embeddings_mask"].any()
    assert "warp_embed" not in program_kinds(pipe)


def test_no_peaks_builds_no_limb_program(params):
    pipe = make(params, with_embeddings=False)
    pipe.keypoint_threshold = 1e9
    out = pipe.process_batch(frames_of(16))
    assert out["poses"] == [[], []]
    assert "limbs" not in program_kinds(pipe)


@pytest.mark.parametrize("kind,buckets,count,capacity,expected", [
    ("embed", [2, 4, 8], 1, 16, 2),
    ("embed", [2, 4, 8], 2, 16, 2),
    ("embed", [2, 4, 8], 3, 16, 4),
    ("embed", [2, 4, 8], 9, 16, 16),
    ("embed", [2, 4, 8], 3, 4, 4),  # buckets at capacity collapse
    ("peak", [4], 1, None, 4),
    ("peak", [4], 4, None, 4),
    ("peak", [4], 5, None, 8),
    ("peak", [4], 5, 16, 16),
])
def test_bucket_selection(kind, buckets, count, capacity, expected):
    pipe = PerceptionPipeline.__new__(PerceptionPipeline)
    pipe.embed_buckets = pipe.peak_buckets = buckets
    pipe.max_peaks = 8
    select = (pipe._select_embed_bucket if kind == "embed"
              else pipe._select_peak_bucket)
    assert select(count, capacity) == expected


def test_escalation_detect_recovers_saturated_batch(params):
    frames = frames_of(17)
    light = {"with_embeddings": False, "with_pose": False}
    out_big = make(params, top_k=256, **light).process_batch(frames)
    assert not out_big["det_overflow"].any(), "need a non-saturated target"
    esc = make(params, top_k=64, max_escalations=2, **light)
    out_esc = esc.process_batch(frames)
    assert esc.escalations["detect"] >= 1
    assert not out_esc["det_overflow"].any()
    k = out_esc["boxes"].shape[1]
    np.testing.assert_array_equal(out_esc["mask"], out_big["mask"][:, :k])
    np.testing.assert_array_equal(out_esc["boxes"], out_big["boxes"][:, :k])
    out_trunc = make(params, top_k=64, **light).process_batch(frames)
    assert out_trunc["det_overflow"].any()
    assert out_trunc["boxes"].shape[1] == 64


def test_escalation_pose_recovers_dropped_peaks(params):
    frames = frames_of(18)
    out_big = make(params, max_peaks=32,
                   with_embeddings=False).process_batch(frames)
    assert not out_big["pose_overflow"].any(), "need a non-saturated target"
    esc = make(params, max_peaks=8, max_escalations=2, with_embeddings=False)
    out_esc = esc.process_batch(frames)
    assert esc.escalations["pose"] >= 1
    assert not out_esc["pose_overflow"].any()
    assert_same_poses(out_esc["poses"], out_big["poses"])


def test_escalation_embed_covers_crowd(params):
    frames = frames_of(19)
    out_big = make(params, max_faces=2, with_pose=False).process_batch(frames)
    occupied = int((out_big["mask"]
                    * np.arange(1, out_big["mask"].shape[1] + 1)).max())
    assert occupied > 1, "scene too sparse to exercise embed escalation"
    esc = make(params, max_faces=1, max_escalations=1, with_pose=False)
    out_esc = esc.process_batch(frames)
    assert esc.escalations["embed"] >= 1
    assert out_esc["embeddings"].shape[1] == 2  # grew past max_faces
    np.testing.assert_array_equal(out_esc["embeddings_mask"],
                                  out_big["embeddings_mask"])
    both = out_esc["embeddings_mask"]
    assert both.any()
    np.testing.assert_allclose(out_esc["embeddings"][both],
                               out_big["embeddings"][both], atol=2e-4)


def test_warmup_runs_the_program_family(params):
    pipe = make(params, max_faces=2)
    pipe.embed_buckets = [1]
    pipe.peak_buckets = [4]
    # detection + embed (k=1, k=2=max_faces) + pose detect + limbs (kb=4,
    # kb=8=max_peaks)
    assert pipe.warmup(batch=2, height=96, width=128) == 1 + 2 + 1 + 2
    before = set(pipe._programs)
    out = pipe.process_batch(frames_of(20))
    assert set(pipe._programs) == before
    assert out["embeddings"].shape == (2, 2, 512)

    fused = make(params, embed_dispatch="fused", limb_dispatch="fused",
                 max_faces=1)
    assert fused.warmup(batch=1, height=96, width=128) == 3


@pytest.mark.parametrize("kwargs,item", [
    ({"mesh": "a world of one"}, "item 6"),
    ({"embed_precision": "int8"}, "item 5"),
    ({"pose_precision": "int8"}, "item 5"),
])
def test_unported_options_raise(params, kwargs, item):
    """The options of ROADMAP Queue 1 items 5 and 6, which once raised, now
    run: a mesh (item 6) takes the mesh's device and gives the batch's
    results; 'int8' (item 5) runs the int8 trunk on weights quantised from
    the float32 masters."""
    if "mesh" in kwargs:
        import torch.distributed as dist

        from terran_tpu_torch.parallel import create_mesh

        assert not dist.is_initialized()
        mesh = create_mesh(devices="cpu")
        try:
            pipe = make(params, mesh=mesh)
            assert pipe.mesh is mesh and pipe.device == mesh.device
            out = pipe.process_batch(frames_of(3))
        finally:
            dist.destroy_process_group()
        assert out["embeddings"].shape == (2, 4, 512)
        return
    pipe = make(params, **kwargs)
    ((keyword, _),) = kwargs.items()
    model, state, conv = (
        (pipe.rec_model, pipe.rec_params, "initial.conv")
        if keyword == "embed_precision"
        else (pipe.pose_model, pipe.pose_params, "conv1_1"))
    assert getattr(pipe, keyword) == "int8"
    assert type(model).__name__.startswith("Int8")
    assert state[f"{conv}.weight_q"].dtype == torch.int8
    assert f"{conv}.weight" not in state
    out = pipe.process_batch(frames_of(3))
    assert out["embeddings"].shape == (2, 4, 512)


def test_matmul_limbs_and_host_plan_parts_raise():
    saved = get_config()
    set_config(dataclasses.replace(saved, limb_backend="matmul"))
    try:
        with pytest.raises(NotImplementedError, match="TPU cost"):
            PerceptionPipeline(det_params={}, device="cpu")
    finally:
        set_config(saved)
    with pytest.raises(ValueError, match="embed_precision"):
        PerceptionPipeline(det_params={}, device="cpu", embed_precision="fp8")


# ---------------------------------------------------------------------------
# Feeding and timing
# ---------------------------------------------------------------------------

def test_threaded_device_put_keeps_order_and_propagates_errors():
    assert list(threaded_device_put(range(10), depth=1,
                                    put=lambda x: 2 * x)) == list(
        range(0, 20, 2))

    def failing_source():
        yield from range(3)
        raise KeyError("source")

    got = []
    with pytest.raises(KeyError, match="source"):
        for item in threaded_device_put(failing_source(), put=lambda x: x):
            got.append(item)
    assert got == [0, 1, 2]

    def failing_put(x):
        if x == 2:
            raise ValueError("put")
        return x

    got = []
    with pytest.raises(ValueError, match="put"):
        for item in threaded_device_put(range(5), put=failing_put):
            got.append(item)
    assert got == [0, 1]


def wait_until(predicate, timeout=30.0):
    """Poll ``predicate`` until it holds; fail after ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while not predicate():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.001)


def test_threaded_device_put_ready_says_whether_next_would_block():
    gates = [threading.Event() for _ in range(2)]

    def gated():
        for i, gate in enumerate(gates):
            assert gate.wait(timeout=30), f"gate {i} never opened"
            yield i

    feed = threaded_device_put(gated(), depth=2, put=lambda x: 10 * x)
    assert iter(feed) is feed
    assert not feed.ready()  # the uploader starts at the first next()
    gates[0].set()
    assert next(feed) == 0
    assert not feed.ready()  # the uploader waits at gate 1
    gates[1].set()
    wait_until(feed.ready)  # item 1 queued
    assert next(feed) == 10
    wait_until(feed.ready)  # the end queued
    assert list(feed) == []


def test_threaded_device_put_stops_uploading_once_closed():
    pulled = []

    def endless():
        while True:
            pulled.append(len(pulled))
            yield pulled[-1]

    feed = threaded_device_put(endless(), depth=2, put=lambda x: x)
    assert [next(feed), next(feed)] == [0, 1]
    feed.close()
    time.sleep(0.3)
    seen = len(pulled)
    time.sleep(0.3)
    assert len(pulled) == seen <= 2 + 2 + 1  # taken, queued, in hand
    with pytest.raises(StopIteration):
        next(feed)


def test_fixed_shape_batches_pads_the_tail():
    frames = np.arange(8 * 2 * 2 * 3, dtype=np.uint8).reshape(8, 2, 2, 3)
    out = list(fixed_shape_batches([frames[:5], frames[5:]], batch_size=4))
    assert [n for _, n in out] == [4, 1, 3]
    assert all(batch.shape == (4, 2, 2, 3) for batch, _ in out)
    np.testing.assert_array_equal(out[1][0], np.repeat(frames[4:5], 4, 0))
    np.testing.assert_array_equal(out[2][0][:3], frames[5:])
    np.testing.assert_array_equal(out[2][0][3], frames[7])
    single = list(fixed_shape_batches([frames[0]]))
    assert single[0][0].shape == (1, 2, 2, 3) and single[0][1] == 1


def test_device_prefetch_yields_tensors_in_order():
    batches = [np.full((1, 2, 2, 3), i, np.uint8) for i in range(4)]
    got = list(device_prefetch(batches, depth=2, device="cpu"))
    assert [int(t[0, 0, 0, 0]) for t in got] == [0, 1, 2, 3]
    assert all(isinstance(t, torch.Tensor) for t in got)


def test_stage_timer_and_timeline_rows():
    timer = StageTimer()
    timeline = Timeline()
    for batch in range(2):
        with timer.stage("fetch", items=4):
            with timeline.span(batch, "fetch", nbytes=16):
                pass
    timeline.mark(1, "done")
    summary = timer.summary()["fetch"]
    assert summary["calls"] == 2 and summary["total_s"] >= 0
    rows = timeline.rows()
    assert [row[:2] for row in rows] == [[0, "fetch"], [1, "fetch"],
                                         [1, "done"]]
    assert rows[0][4] == 16 and rows[2][3] == 0.0
    timer.reset()
    assert timer.summary() == {}


def test_upload_bytes_counts_every_concurrent_upload(params):
    pipe = make(params, with_embeddings=False, with_pose=False)
    chunk = np.zeros((1, 4, 4, 3), np.uint8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [pipe.put_frames(chunk) for _ in range(200)])
            for _ in range(8)]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=60)
        assert not any(worker.is_alive() for worker in workers)
    finally:
        sys.setswitchinterval(interval)
    assert pipe.upload_bytes == 8 * 200 * chunk.nbytes


# ---------------------------------------------------------------------------
# CUDA graphs: which pipelines capture, how calls are routed and counted
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,mesh,plan,embed,pose,expected", [
    ("cuda", None, "device", "native", "native", True),
    ("cuda:0", None, "device", "native", "native", True),
    ("cuda", "a mesh", "device", "native", "native", False),
    ("cuda", None, "host", "native", "native", False),
    ("cuda", None, "device", "int8", "native", False),
    ("cuda", None, "device", "native", "int8", False),
    ("cpu", None, "device", "native", "native", False),
])
def test_graphs_eligible(device, mesh, plan, embed, pose, expected):
    assert graphs_eligible(device, mesh, plan, embed, pose) is expected


def program_keys(pipe):
    """The (kind, key) of every device program the pipeline built."""
    return set(pipe._programs)


@pytest.mark.parametrize("builder,args", [
    ("_perception_fn", (96, 128)),
    ("_warp_embed_fn", (2, (2, 96, 128, 3))),
    ("_pose_fn", (96, 128)),
    ("_pose_detect_fn", (96, 128)),
    ("_limb_fn", (4, (2, 12, 16, 38))),
])
def test_a_program_is_built_once_per_key(params, builder, args):
    """Every call at one key returns the same closure, which a captured
    graph's key holds; another key builds another."""
    pipe = make(params)
    build = getattr(pipe, builder)
    program = build(*args)
    assert build(*args) is program
    assert len(program_keys(pipe)) == 1
    other = build(args[0] * 2, *args[1:])
    assert other is not program and len(program_keys(pipe)) == 2


def test_graph_calls_count_eager_on_cpu(params):
    pipe = make(params)
    pipe.process_batch(frames_of(21))
    # No warmup: each program built ran once, eagerly.
    calls = len(program_keys(pipe))
    assert calls >= 2
    assert pipe.graph_calls == {"replayed": 0, "eager": calls}
    assert pipe.warmup(batch=2, height=96, width=128) > 0
    assert pipe._graphs == {}  # no card: nothing captured
    assert pipe.graph_calls["eager"] == calls  # warmup's runs not counted


def test_graph_records_only_with_a_timer(params):
    pipe = make(params, with_embeddings=False)
    pipe.process_batch(frames_of(22))
    before = dict(pipe.graph_calls)
    timer = pipe.timer = StageTimer()
    pipe.process_batch(frames_of(23))
    eager = pipe.graph_calls["eager"] - before["eager"]
    assert eager >= 1 and pipe.graph_calls["replayed"] == 0
    assert timer.counts["graph_eager"] == timer.items["graph_eager"] == eager
    assert "graph_replay" not in timer.counts
    pipe.timer = None
    pipe.process_batch(frames_of(24))
    assert timer.counts["graph_eager"] == eager


def _flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return list(out.values()) if isinstance(out, dict) else list(out)


class StandInGraph(pipeline_module._Graph):
    """A captured graph's stand-in on the CPU: static input and output
    buffers, and a replay that runs the program on the static inputs into
    the static outputs, as a CUDA graph's replay does. Calls go through
    the real ``_Graph.__call__``."""

    def __init__(self, fn, args):
        self.inputs = tuple(a.clone() for a in args)
        self.outputs = fn(*self.inputs)

        def replay():
            for buffer, value in zip(_flat(self.outputs),
                                     _flat(fn(*self.inputs))):
                buffer.copy_(value)

        self.graph = SimpleNamespace(replay=replay)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    monkeypatch.setattr(pipeline_module, "graphs_eligible",
                        lambda *settings: True)
    monkeypatch.setattr(pipeline_module, "_Graph", StandInGraph)


def recorded_peak_tables(monkeypatch):
    """The peak and limb tables the pipeline hands its pose assembly."""
    tables = []
    assemble = pipeline_module.assemble_humans

    def recording(*args, **kwargs):
        tables.append([np.array(a) for a in args])
        return assemble(*args, **kwargs)

    monkeypatch.setattr(pipeline_module, "assemble_humans", recording)
    return tables


@pytest.mark.parametrize("dispatch", ["adaptive", "fused"])
def test_replayed_programs_match_eager_launches(params, stand_in_graphs,
                                                monkeypatch, dispatch):
    """Warmup captures every program it runs, with its count and program
    caches as an eager pipeline's; a depth-2 stream over distinct batches
    then replays every call and yields what the eager closures yield, bit
    for bit, peak and limb tables included: a batch's PAF is read after
    two later batches' pose programs replayed."""
    pipe = make(params, max_faces=2, embed_dispatch=dispatch,
                limb_dispatch=dispatch)
    pipe.embed_buckets = [1]
    pipe.peak_buckets = [4]
    for name, value in LOWERED_POSE_THRESHOLDS.items():
        setattr(pipe, name, value)
    plain = make(params, max_faces=2, embed_dispatch=dispatch,
                 limb_dispatch=dispatch)
    plain.embed_buckets, plain.peak_buckets = [1], [4]
    count = pipe.warmup(batch=2, height=96, width=128)
    assert count == plain.warmup(batch=2, height=96, width=128)
    assert program_keys(pipe) == program_keys(plain)
    assert len(pipe._graphs) == count
    assert pipe.graph_calls == {"replayed": 0, "eager": 0}

    batches = [frames_of(30 + i) for i in range(3)]
    tables = recorded_peak_tables(monkeypatch)
    got = list(pipe.process_stream(batches, depth=2))
    replayed = pipe.graph_calls["replayed"]
    assert replayed >= 2 * len(batches)
    assert pipe.graph_calls["eager"] == 0
    got_tables, tables[:] = list(tables), []
    graphs, pipe._graphs = pipe._graphs, {}
    expected = list(pipe.process_stream(batches, depth=2))
    pipe._graphs = graphs
    assert pipe.graph_calls == {"replayed": replayed, "eager": replayed}
    for g, e in zip(got, expected):
        assert_same_results(g, e)
    assert len(got_tables) == len(tables) == 2 * len(batches)
    for g, e in zip(got_tables, tables):
        for a, b in zip(g, e):
            np.testing.assert_array_equal(a, b)

    pipe.process_batch(batches[0][:1])  # a short batch has no graph
    assert pipe.graph_calls["replayed"] == replayed
    assert pipe.graph_calls["eager"] > replayed


@pytest.mark.parametrize("name,value", [("threshold", 0.9),
                                        ("keypoint_threshold", 0.1),
                                        ("thresh_midpoint", 0.1)])
def test_threshold_changed_after_warmup_runs_eager(params, stand_in_graphs,
                                                   name, value):
    """A graph holds the thresholds its program read when captured: once
    one changes, calls run the eager closures, which read the new value,
    equal to a pipeline built at it; the next warmup captures at it."""
    pipe = make(params, max_faces=2)
    plain = make(params, max_faces=2)
    for p in (pipe, plain):
        for key, lowered in LOWERED_POSE_THRESHOLDS.items():
            setattr(p, key, lowered)
    count = pipe.warmup(batch=2, height=96, width=128)
    batch = frames_of(40)
    pipe.process_batch(batch)
    replayed = pipe.graph_calls["replayed"]
    assert replayed >= 2 and pipe.graph_calls["eager"] == 0

    setattr(pipe, name, value)
    setattr(plain, name, value)
    assert_same_results(pipe.process_batch(batch), plain.process_batch(batch))
    eager = pipe.graph_calls["eager"]
    assert pipe.graph_calls["replayed"] == replayed and eager >= 2

    assert pipe.warmup(batch=2, height=96, width=128) == count
    assert len(pipe._graphs) == 2 * count
    assert_same_results(pipe.process_batch(batch), plain.process_batch(batch))
    assert pipe.graph_calls["eager"] == eager
    assert pipe.graph_calls["replayed"] > replayed
