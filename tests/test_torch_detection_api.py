"""Port's detection step and task API (RetinaFaceDetector, Detection) vs
the JAX package, in float32 on the CPU.

The detect step runs at ``__graft_entry__.entry()``'s shape (2x256x320,
top_k 64, score threshold 0.5, IoU 0.4) on the same random weights: keep
masks and overflow flags equal; kept scores within 1e-5; kept boxes and
landmarks within atol 1e-3 plus 2e-5 of the largest coordinate of their
row. Float32 head outputs differ by summation order (about 1e-5
relative) and ``exp`` by ulps, and random weights put box corners at
thousands of pixels. The task API sees images already at its short
side, so both resizes are the identity: faces come in the same number and
order, scores within 1e-5, and int32 boxes and landmarks within one
count, since a float coordinate that differs by 1e-5 relative can round
to the other integer.
"""

import numpy as np
import pytest
import torch

from terran_tpu.face.detection import Detection as JaxDetection
from terran_tpu.face.detection import RetinaFaceDetector as JaxDetector
from terran_tpu.models import retinaface as jax_rf
from terran_tpu.utils.batching import merge_factory as jax_merge
from terran_tpu.utils.batching import resize_factory as jax_resize
from terran_tpu.utils.convert import convert_retinaface as jax_convert
from terran_tpu.utils.convert import save_params
from terran_tpu_torch.checkpoint import load_checkpoint_params
from terran_tpu_torch.face import Detection
from terran_tpu_torch.face.detection import RetinaFaceDetector
from terran_tpu_torch.models import retinaface as rf
from terran_tpu_torch.utils.batching import merge_factory, resize_factory
from terran_tpu_torch.utils.convert import convert_retinaface
from torch_oracle import random_retinaface_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401

SHORT_SIDE = 96


@pytest.fixture(scope="module")
def state_dict():
    # The weights of __graft_entry__._random_params("retinaface").
    return random_retinaface_state_dict(np.random.default_rng(0))


# Above the anchor count of every task-API input below: with random
# weights hundreds of anchors clear 0.5, and the comparison should not
# hinge on where a top-K cut falls among them.
TOP_K = 1024


@pytest.fixture(scope="module")
def detector(state_dict):
    return RetinaFaceDetector(params=convert_retinaface(state_dict),
                              device="cpu", top_k=TOP_K)


@pytest.fixture(scope="module")
def jax_detector(state_dict):
    return JaxDetector(params=jax_convert(state_dict), top_k=TOP_K)


def unpacked(packed):
    return rf.unpack_detections(np.asarray(packed))


def assert_rows_close(got, exp):
    """|got - exp| <= 1e-3 + 2e-5 * (largest |coordinate| of the row)."""
    got = np.asarray(got, np.float32).reshape(len(exp), -1)
    exp = np.asarray(exp, np.float32).reshape(len(exp), -1)
    scale = np.abs(exp).max(axis=-1, keepdims=True)
    assert (np.abs(got - exp) <= 1e-3 + 2e-5 * scale).all()


def assert_same_detections(got, exp):
    g_boxes, g_lmks, g_scores, g_mask, g_over = got
    e_boxes, e_lmks, e_scores, e_mask, e_over = exp
    np.testing.assert_array_equal(g_mask, e_mask)
    np.testing.assert_array_equal(g_over, e_over)
    assert_rows_close(g_boxes[g_mask], e_boxes[e_mask])
    assert_rows_close(g_lmks[g_mask], e_lmks[e_mask])
    np.testing.assert_allclose(g_scores[g_mask], e_scores[e_mask], rtol=0,
                               atol=1e-5)


def test_detect_step_matches_jax_at_entry_shape(state_dict):
    images = np.random.default_rng(0).integers(
        0, 255, (2, 256, 320, 3)).astype(np.uint8)
    model = rf.RetinaFace()
    model.load_state_dict(convert_retinaface(state_dict), strict=True)
    detect = rf.make_detect_fn(model, 256, 320, nms_threshold=0.4, top_k=64)
    got = unpacked(detect(torch.from_numpy(images), 0.5))
    jax_detect = jax_rf.make_detect_fn(jax_rf.RetinaFace(), 256, 320,
                                       nms_threshold=0.4, top_k=64)
    exp = unpacked(jax_detect(jax_convert(state_dict), images, 0.5))
    assert got[3].sum() > 0, "no detections to compare"
    assert_same_detections(got, exp)


def test_pad_bucketing_masks_the_margin(state_dict, detector, jax_detector):
    """'pad' runs 90x150 at 128x192; cells past ceil(valid / stride) are
    masked exactly as in the JAX detect step."""
    images = np.random.default_rng(3).integers(
        0, 255, (1, 90, 150, 3)).astype(np.uint8)
    padded = np.zeros((1, 128, 192, 3), np.uint8)
    padded[:, :90, :150] = images
    got = unpacked(detector._detect_fn(128, 192)(
        torch.from_numpy(padded), 0.5, 150, 90))
    exp = unpacked(jax_detector._detect_fn(128, 192)(
        jax_detector.params, padded, 0.5, 150, 90))
    assert_same_detections(got, exp)
    full = unpacked(detector._detect_fn(128, 192)(torch.from_numpy(padded),
                                                  0.5))
    assert full[3].sum() > got[3].sum()

    pad = RetinaFaceDetector(params=convert_retinaface(state_dict),
                             device="cpu", top_k=TOP_K, bucketing="pad")
    jax_pad = JaxDetector(params=jax_convert(state_dict), top_k=TOP_K,
                          bucketing="pad")
    assert_same_faces(pad.call(images), jax_pad.call(images), rounded=False)


def assert_same_faces(got, exp, rounded=True):
    assert len(got) == len(exp)
    for faces_g, faces_e in zip(got, exp):
        assert len(faces_g) == len(faces_e)
        if not faces_g:
            continue
        for g in faces_g:
            assert set(g) == {"bbox", "landmarks", "score"}
        np.testing.assert_allclose([f["score"] for f in faces_g],
                                   [f["score"] for f in faces_e], atol=1e-5)
        for key in ("bbox", "landmarks"):
            g = np.stack([f[key] for f in faces_g])
            e = np.stack([f[key] for f in faces_e])
            if rounded:
                assert g.dtype == np.int32
                assert np.abs(g - e).max() <= 1
            else:
                assert_rows_close(g, e)


def make_tasks(detector, jax_detector):
    task = Detection.__new__(Detection)
    task.model = detector
    task.resize_in, task.resize_out = resize_factory(SHORT_SIDE, "cpu")
    task.merge_in, task.merge_out = merge_factory()
    jax_task = JaxDetection.__new__(JaxDetection)
    jax_task.model = jax_detector
    jax_task.resize_in, jax_task.resize_out = jax_resize(SHORT_SIDE)
    jax_task.merge_in, jax_task.merge_out = jax_merge()
    return task, jax_task


def test_detection_matches_jax(detector, jax_detector):
    task, jax_task = make_tasks(detector, jax_detector)
    rng = np.random.default_rng(6)
    batch = rng.integers(0, 255, (2, SHORT_SIDE, 160, 3), dtype=np.uint8)
    out = task(batch)
    assert sum(len(f) for f in out) > 0, "no faces to compare"
    assert_same_faces(out, jax_task(batch))
    for face in out[0]:
        assert face["bbox"].shape == (4,)
        assert face["landmarks"].shape == (5, 2)
        assert face["landmarks"].dtype == np.int32
    scores = [f["score"] for f in out[0]]
    assert scores == sorted(scores, reverse=True)

    # A list of mixed sizes is padded into one batch on the device, and a
    # single (H, W, 3) image comes back unbatched.
    frames = [batch[0], batch[1][:, :128]]
    assert_same_faces(task(frames), jax_task(frames))
    assert_same_faces([task(batch[0])], [jax_task(batch[0])])


def test_escalation_keeps_what_a_large_top_k_keeps(state_dict, detector):
    images = np.random.default_rng(4).integers(
        0, 255, (1, 96, 96, 3), dtype=np.uint8)
    big = detector.call(images, threshold=0.5)[0]
    assert len(big) > 8, "scene too sparse to exercise escalation"
    esc = RetinaFaceDetector(params=convert_retinaface(state_dict),
                             device="cpu", top_k=8, max_escalations=6)
    out = esc.call(images, threshold=0.5)[0]
    assert esc.escalation_count >= 1
    assert len(out) == len(big)
    for a, b in zip(out, big):
        np.testing.assert_array_equal(a["bbox"], b["bbox"])
    trunc = RetinaFaceDetector(params=convert_retinaface(state_dict),
                               device="cpu", top_k=8, max_escalations=0)
    assert len(trunc.call(images, threshold=0.5)[0]) <= 8


def test_detection_loads_the_converted_store(state_dict, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("TERRAN_TPU_HOME", str(tmp_path))
    (tmp_path / "checkpoints").mkdir()
    save_params(tmp_path / "checkpoints" / "b5d77fff.npz",
                jax_convert(state_dict))
    loaded = load_checkpoint_params(RetinaFaceDetector.CHECKPOINT_CLASS)
    direct = convert_retinaface(state_dict)
    assert loaded.keys() == direct.keys()
    for key in direct:
        assert torch.equal(loaded[key], direct[key]), key
    task = Detection(device="cpu", short_side=SHORT_SIDE, top_k=16)
    assert isinstance(task.model, RetinaFaceDetector)
    assert task.model.top_k == 16


def test_pad_buffer_cache_bounded(detector):
    rng = np.random.default_rng(11)
    for n, h, w in [(1, 90, 90), (2, 90, 90), (1, 60, 120), (2, 60, 120),
                    (3, 90, 90), (1, 120, 60)]:
        detector.bucketing = "pad"
        try:
            detector.call(rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8),
                          threshold=0.99)
        finally:
            detector.bucketing = "exact"
    assert len(detector._pad_local.buffers) <= 4
