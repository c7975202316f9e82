"""The port's 'host' transfer plan, float32 on the CPU.

Against ``terran_tpu.pipeline.PerceptionPipeline(transfer_plan='host',
host_resize='exact')`` on the same weights (``tests/test_pipeline.py``'s
tiny configuration: weights from ``default_rng(33)``, top_k 16, max_faces
4, max_peaks 8, no escalation), at the shapes where both packages' exact
resizes agree bit for bit: (2, 96, 128, 3) at det and pose short side 96
(the identity) and (2, 128, 192, 3) at det 64 and pose 32 (x1/2 and x1/4,
with the pose thresholds lowered so that random weights assemble humans).
Boxes, landmarks, scores, masks and keypoints equal; embeddings within
``atol=2e-4``, the JAX package's own tolerance between its two plans
(``tests/test_pipeline.py``): the crops are equal (the same numpy warp),
and the two FaceResNet100 forwards sum in other orders.

The rest holds the port's host plan to its device plan, which it equals
exactly on the CPU (the exact host resize is the device plan's resize
function, and the numpy warp is its warp, operation for operation), and
covers the stream, escalation, construction, the embed worker's lifetime
and warmup.
"""

import builtins

import numpy as np
import pytest

from terran_tpu.pipeline import PerceptionPipeline as JaxPipeline
from terran_tpu.utils.convert import convert_arcface as jax_convert_arcface
from terran_tpu.utils.convert import convert_openpose as jax_convert_openpose
from terran_tpu.utils.convert import (
    convert_retinaface as jax_convert_retinaface,
)
from terran_tpu_torch.ops.resize import resize_bilinear_u8_cv2
from terran_tpu_torch.ops.warp import (
    warp_affine_u8_batch_cv2, warp_affine_u8_batch_numpy,
)
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.utils.profiling import StageTimer, Timeline
from torch_oracle import (
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict,
)
from torch_port_fixtures import (  # noqa: F401
    single_torch_thread, single_torch_thread_module,
)

TINY = {"top_k": 16, "max_faces": 4, "max_peaks": 8, "max_escalations": 0}
LOWERED_POSE_THRESHOLDS = {"keypoint_threshold": -1e9,
                           "thresh_midpoint": -1e9, "human_threshold": -1e9}
HOST = {"transfer_plan": "host", "host_resize": "exact"}
# The JAX class's jitted programs, replaced by stubs to count what its
# warmup runs without compiling them.
JAX_PROGRAMS = ("_perception_fn", "_embed_fn", "_warp_embed_fn",
                "_pose_detect_fn", "_limb_fn", "_pose_fn")


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(33)
    return (jax_convert_retinaface(random_retinaface_state_dict(rng)),
            jax_convert_arcface(random_arcface_state_dict(rng)),
            jax_convert_openpose(random_openpose_state_dict(rng)))


def frames_of(seed, shape=(2, 96, 128, 3)):
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


def make(params, lowered=False, **kwargs):
    """A CPU pipeline of the port at the tiny capacities, det short side
    64 and pose 32 (dyadic for 128x192 frames) unless ``kwargs`` say."""
    config = dict(TINY, det_short_side=64, pose_short_side=32)
    config.update(kwargs)
    pipe = PerceptionPipeline(*params, device="cpu", **config)
    for name, value in (LOWERED_POSE_THRESHOLDS.items() if lowered else ()):
        setattr(pipe, name, value)
    return pipe


def keypoints(poses):
    return [[person["keypoints"].tolist() for person in frame]
            for frame in poses]


def assert_same_results(got, expected):
    """Every output equal: arrays, keypoints and human scores."""
    assert got.keys() == expected.keys()
    for key, value in expected.items():
        if key == "poses":
            assert keypoints(got[key]) == keypoints(value)
            assert ([[p["score"] for p in f] for f in got[key]]
                    == [[p["score"] for p in f] for f in value])
        else:
            np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("shape,det_side,pose_side,lowered", [
    ((96, 128), 96, 96, False),
    ((128, 192), 64, 32, True),
])
def test_host_plan_matches_jax_host_plan(jax_params, shape, det_side,
                                         pose_side, lowered):
    config = dict(TINY, det_short_side=det_side, pose_short_side=pose_side,
                  **HOST)
    frames = frames_of(5, (2,) + shape + (3,))
    with JaxPipeline(*jax_params, **config) as jax_pipe, \
            make(jax_params, lowered, **config) as port:
        for name, value in (LOWERED_POSE_THRESHOLDS.items() if lowered
                            else ()):
            setattr(jax_pipe, name, value)
        exp = jax_pipe.process_batch(frames)
        got = port.process_batch(frames)

    assert got.keys() == exp.keys()
    for key in ("boxes", "landmarks", "scores", "mask", "det_overflow",
                "pose_overflow", "embeddings_mask"):
        assert got[key].dtype == exp[key].dtype, key
        np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
    valid = exp["embeddings_mask"]
    assert valid.any(), "no embeddings to compare"
    np.testing.assert_allclose(got["embeddings"][valid],
                               exp["embeddings"][valid], rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got["embeddings"][~valid], 0.0)
    assert keypoints(got["poses"]) == keypoints(exp["poses"])
    if lowered:
        assert sum(map(len, exp["poses"])) > 0, "no humans to compare"


@pytest.fixture(scope="module")
def plans(jax_params):
    """The port's device and host plans on one dyadic batch, humans
    assembled, and the host plan's pipeline with its StageTimer."""
    frames = frames_of(6, (2, 128, 192, 3))
    device = make(jax_params, lowered=True).process_batch(frames)
    timer = StageTimer()
    host = make(jax_params, lowered=True, timer=timer, **HOST)
    yield frames, device, host, host.process_batch(frames), timer
    host.close()


def test_host_plan_matches_device_plan(plans):
    _, device, host, out, timer = plans
    assert_same_results(out, device)
    assert sum(map(len, out["poses"])) > 0
    assert out["mask"].any()
    assert timer.summary()["embed_host_warp"]["calls"] == 1
    # Only the resizes and the crops crossed the link: (64x96 + 32x48)
    # x 3 bytes a frame, then the 4 crops a frame and their mask.
    assert host.upload_bytes == 2 * 3 * (64 * 96 + 32 * 48) + (
        2 * 4 * 112 * 112 * 3 + 2 * 4) + 2 * 18 * 8 * 3 * 4


def test_process_stream_matches_process_batch(plans):
    frames, _, host, out, timer = plans
    host.timeline = Timeline()
    timer.reset()
    try:
        batches = [frames, frames_of(7, frames.shape), frames]
        streamed = list(host.process_stream(batches, depth=2))
        events = {row[1] for row in host.timeline.rows()}
    finally:
        host.timeline = None
    assert len(streamed) == 3
    assert {"host_resize_thread", "h2d_thread", "perception_step",
            "embed_host_warp", "embed_dispatch", "embed_fetch",
            "pose_assembly"} <= events
    summary = timer.summary()
    for stage in ("host_resize_thread", "h2d_thread", "embed_host_warp",
                  "embed_dispatch"):
        assert summary[stage]["calls"] == 3, stage
    assert "host_prep" not in summary  # the threads did the prep
    assert_same_results(streamed[0], out)
    assert_same_results(streamed[2], out)
    assert_same_results(streamed[1], host.process_batch(batches[1]))


def test_escalation_under_the_host_plan(jax_params):
    """Detect and embed escalations re-dispatch on the resident
    detection-size upload and the host-resident frames, as the device
    plan does on its frames."""
    frames = frames_of(17)
    esc = {"top_k": 64, "max_faces": 1, "max_escalations": 2,
           "det_short_side": 64, "pose_short_side": 48}
    host = make(jax_params, **esc, **HOST)
    device = make(jax_params, **esc)
    out = host.process_batch(frames)
    assert host.escalations["detect"] >= 1
    assert host.escalations["embed"] >= 1
    assert not out["det_overflow"].any()
    assert out["embeddings"].shape[1] > 1  # grew past max_faces
    assert_same_results(out, device.process_batch(frames))
    assert host.escalations == device.escalations
    for streamed in host.process_stream([frames, frames]):
        assert_same_results(streamed, out)
    host.close()


@pytest.mark.parametrize("kwargs,error,match", [
    ({"transfer_plan": "host", "embed_dispatch": "fused"}, ValueError,
     "adaptive"),
    ({"transfer_plan": "host", "limb_dispatch": "fused"}, ValueError,
     "adaptive"),
    ({"transfer_plan": "pcie"}, ValueError, "transfer_plan"),
    ({"transfer_plan": "host", "host_resize": "gpu"}, ValueError,
     "host_resize"),
])
def test_construction_errors(kwargs, error, match):
    with pytest.raises(error, match=match):
        PerceptionPipeline(det_params={}, device="cpu", **kwargs)


def test_host_plan_without_the_models_it_skips(jax_params):
    """The adaptive requirement binds only the branches that run."""
    det, rec, _ = jax_params
    pipe = PerceptionPipeline(det, rec, None, device="cpu", with_pose=False,
                              limb_dispatch="fused", **TINY, **HOST)
    out = pipe.process_batch(frames_of(8, (1, 64, 96, 3)))
    assert "poses" not in out and out["embeddings"].shape == (1, 4, 512)
    pipe.close()


@pytest.fixture
def without_cv2(monkeypatch):
    real_import = builtins.__import__

    def blocked(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("cv2 blocked")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", blocked)


def test_cv2_required_but_missing_raises_at_construction(without_cv2):
    with pytest.raises(ImportError, match="cv2"):
        PerceptionPipeline(det_params={}, device="cpu", host_resize="cv2")


def test_auto_falls_back_to_the_exact_chain(jax_params, without_cv2):
    pipe = make(jax_params, transfer_plan="host")
    assert pipe.host_resize == "auto" and not pipe._uses_cv2()
    assert pipe._host_warp_fn() is warp_affine_u8_batch_numpy
    frames = frames_of(9, (1, 128, 192, 3))
    np.testing.assert_array_equal(
        pipe._host_resize(frames, 37, 53),
        PerceptionPipeline._host_resize(
            make(jax_params, **HOST), frames, 37, 53))


def test_auto_takes_cv2_where_it_imports(jax_params):
    pipe = make(jax_params, transfer_plan="host", host_resize="auto")
    assert pipe._uses_cv2()
    assert pipe._host_warp_fn() is warp_affine_u8_batch_cv2
    frames = frames_of(10, (2, 128, 192, 3))
    np.testing.assert_array_equal(pipe._host_resize(frames, 37, 53),
                                  resize_bilinear_u8_cv2(frames, 37, 53))
    out = pipe.process_batch(frames)  # OpenCV's crops: within a count
    assert out["embeddings"].shape == (2, 4, 512)
    assert len(out["poses"]) == 2
    pipe.close()


def test_close_is_idempotent_and_the_pipeline_stays_usable(plans):
    frames, _, host, out, _ = plans
    worker = host._embed_pool()
    host.close()
    host.close()
    assert host._embed_pool_obj is None
    assert_same_results(host.process_batch(frames), out)
    assert host._embed_pool() is not worker  # a new worker
    with host as same:
        assert same is host
        assert_same_results(same.process_batch(frames), out)
    assert host._embed_pool_obj is None
    assert_same_results(host.process_batch(frames), out)
    host.close()


def test_warmup_runs_the_jax_class_programs(jax_params):
    """The port's warmup under the 'host' plan runs as many device
    programs as the JAX class's (counted with its jitted programs
    replaced by stubs), and after it a batch builds no new program."""
    config = dict(TINY, max_faces=2, det_short_side=64, pose_short_side=32,
                  **HOST)
    jax_pipe = JaxPipeline(*jax_params, **config)
    port = make(jax_params, **config)
    for pipe in (jax_pipe, port):
        pipe.embed_buckets = [1]
        pipe.peak_buckets = [4]

    def stub(*args, **kwargs):
        return lambda *inputs: (None, np.zeros((2, 16, 24, 38)))

    for name in JAX_PROGRAMS:
        setattr(jax_pipe, name, stub)
    jax_count = jax_pipe.warmup(batch=2, height=128, width=192)
    # detection + embed (k=1, k=2=max_faces) + pose detect + limbs (kb=4,
    # kb=8=max_peaks)
    assert jax_count == 1 + 2 + 1 + 2
    assert port.warmup(batch=2, height=128, width=192) == jax_count

    before = set(port._programs)
    out = port.process_batch(frames_of(11, (2, 128, 192, 3)))
    assert set(port._programs) == before
    # The host plan embeds crops.
    assert all(kind != "warp_embed" for kind, _ in port._programs)
    assert out["embeddings"].shape == (2, 2, 512)
    port.close()
