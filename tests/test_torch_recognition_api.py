"""Port's recognition task API (ArcFaceRecognizer, Recognition) and the
whole face path vs the JAX package, in float32 on the CPU.

Aligned crops are rounded to uint8 counts on both sides; the warp's
sample coordinates differ by an FMA-contraction ulp between XLA and torch,
so a crop pixel next to a .5 tie can round one count apart (crops compare
within one count). Embeddings are unit vectors and compare within atol
1e-4: float32 summation order through 100 layers moves them by about
1e-5, and so does a crop value one count apart.
"""

import numpy as np
import pytest

from terran_tpu.face.detection import RetinaFaceDetector as JaxDetector
from terran_tpu.face.recognition import ArcFaceRecognizer as JaxRecognizer
from terran_tpu.utils.convert import convert_arcface as jax_convert_arcface
from terran_tpu.utils.convert import convert_retinaface as jax_convert_rf
from terran_tpu_torch.face import Recognition
from terran_tpu_torch.face.detection import RetinaFaceDetector
from terran_tpu_torch.face.recognition import ArcFaceRecognizer
from terran_tpu_torch.ops.warp import ARCFACE_TEMPLATE
from terran_tpu_torch.utils.convert import convert_arcface, convert_retinaface
from torch_oracle import random_arcface_state_dict, random_retinaface_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401

EMB_ATOL = 1e-4


@pytest.fixture(scope="module")
def arcface_sd():
    return random_arcface_state_dict(np.random.default_rng(11))


@pytest.fixture(scope="module")
def recognizer(arcface_sd):
    return ArcFaceRecognizer(params=convert_arcface(arcface_sd), device="cpu")


@pytest.fixture(scope="module")
def jax_recognizer(arcface_sd):
    return JaxRecognizer(params=jax_convert_arcface(arcface_sd))


def face_at(cx, cy, size=60.0):
    """A detection whose landmarks are the template scaled and moved."""
    lmk = (ARCFACE_TEMPLATE - ARCFACE_TEMPLATE.mean(axis=0)) * (
        size / 112.0) + (cx, cy)
    return {"bbox": np.array([cx - size / 2, cy - size / 2, cx + size / 2,
                              cy + size / 2], np.int32),
            "landmarks": lmk.astype(np.int32), "score": 0.99}


def assert_same_embeddings(got, exp):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert g.shape == e.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, e, rtol=0, atol=EMB_ATOL)
        if len(g):
            np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0,
                                       rtol=1e-5)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(21)
    images = [rng.integers(0, 255, (160, 200, 3), dtype=np.uint8),
              rng.integers(0, 255, (150, 240, 3), dtype=np.uint8),
              rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)]
    faces = [[face_at(100, 80), face_at(60, 60, 40.0)],
             [face_at(150, 75, 90.0)], []]
    return images, faces


def test_call_with_faces_matches_jax(recognizer, jax_recognizer, scene):
    images, faces = scene
    got = recognizer.call(images, faces)
    assert [g.shape for g in got] == [(2, 512), (1, 512), (0, 512)]
    assert_same_embeddings(got, jax_recognizer.call(images, faces))


def test_align_matches_jax(recognizer, jax_recognizer, scene):
    images, faces = scene
    got = recognizer.align(images[0], faces[0])
    exp = jax_recognizer.align(images[0], faces[0])
    assert got.shape == exp.shape == (2, 112, 112, 3)
    assert np.abs(got - exp).max() <= 1.0
    assert (got == exp).mean() > 0.99


def test_embed_ready_crops_matches_jax(recognizer, jax_recognizer):
    crops = np.random.default_rng(3).integers(
        0, 255, (2, 112, 112, 3)).astype(np.float32)
    np.testing.assert_allclose(recognizer._embed(crops),
                               jax_recognizer._embed(crops), rtol=0,
                               atol=1e-4)


def test_recognition_task_split_and_expansion(recognizer, scene):
    images, faces = scene
    task = Recognition.__new__(Recognition)
    task.model = recognizer
    per_image = task(images, faces)
    assert [f.shape for f in per_image] == [(2, 512), (1, 512), (0, 512)]
    np.testing.assert_array_equal(task(images[0], faces[0]), per_image[0])
    np.testing.assert_array_equal(task(images[1], faces[1][0]), per_image[1])
    with pytest.raises(ValueError):
        task(images[:2], faces[:1])


def test_no_landmarks_branch_raises(recognizer, scene):
    images, _ = scene
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        recognizer.call(images[:1], None)
    task = Recognition.__new__(Recognition)
    task.model = recognizer
    with pytest.raises(NotImplementedError):
        task(images[0])


def test_face_path_matches_jax(recognizer, jax_recognizer):
    """Detection, then recognition of the detected faces, against the JAX
    package. Faces come from the same random RetinaFace weights; each
    image's two strongest faces go to recognition (the embedding network
    on every random-weight detection would take minutes on the CPU), all
    with finite int32 landmarks."""
    sd = random_retinaface_state_dict(np.random.default_rng(0))
    detector = RetinaFaceDetector(params=convert_retinaface(sd),
                                  device="cpu", top_k=1024)
    jax_detector = JaxDetector(params=jax_convert_rf(sd), top_k=1024)
    images = np.random.default_rng(22).integers(
        0, 255, (2, 96, 128, 3), dtype=np.uint8)
    faces = detector.call(images)
    jax_faces = jax_detector.call(images)
    assert [len(f) for f in faces] == [len(f) for f in jax_faces]
    for ours, theirs in zip(faces, jax_faces):
        assert ours, "no faces to recognise"
        for g, e in zip(ours, theirs):
            np.testing.assert_allclose(g["score"], e["score"], atol=1e-5)

    # Recognition on the JAX detections' landmarks, rounded to int32 as
    # the task API's resize_out does, so both recognizers align the same
    # points.
    chosen = [[{"landmarks": np.around(f["landmarks"]).astype(np.int32)}
               for f in image_faces[:2]] for image_faces in jax_faces]
    for image_faces in chosen:
        for face in image_faces:
            assert np.isfinite(face["landmarks"]).all()
    got = recognizer.call(list(images), chosen)
    assert [g.shape for g in got] == [(2, 512), (2, 512)]
    assert_same_embeddings(got, jax_recognizer.call(list(images), chosen))
