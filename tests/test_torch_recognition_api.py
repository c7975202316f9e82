"""Port's recognition task API (ArcFaceRecognizer, Recognition) and the
whole face path vs the JAX package, in float32 on the CPU.

Aligned crops are rounded to uint8 counts on both sides; the warp's
sample coordinates differ by an FMA-contraction ulp between XLA and torch,
so a crop pixel next to a .5 tie can round one count apart (crops compare
within one count). Embeddings are unit vectors and compare within atol
1e-4: float32 summation order through 100 layers moves them by about
1e-5, and so does a crop value one count apart. Without landmarks both
packages resize whole images with PIL's BICUBIC arithmetic (the JAX
package through PIL, the port in float64 on tensors): the crops are
held within one count and counted for differing values.
"""

import numpy as np
import pytest
import torch

from terran_tpu.face.detection import RetinaFaceDetector as JaxDetector
from terran_tpu.face.recognition import ArcFaceRecognizer as JaxRecognizer
from terran_tpu.utils.convert import convert_arcface as jax_convert_arcface
from terran_tpu.utils.convert import convert_retinaface as jax_convert_rf
from terran_tpu_torch.face import Recognition
from terran_tpu_torch.face.detection import RetinaFaceDetector
from terran_tpu_torch.face.recognition import (
    ArcFaceRecognizer, preprocess_face_no_landmarks, resize_pil_bicubic,
)
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


# (H, W) of whole-image faces: upscaled, downscaled, odd aspect ratios, a
# side of one pixel, squares at, above and below the crop side.
NO_LANDMARK_SHAPES = [(37, 51), (200, 160), (640, 480), (90, 300),
                      (1, 80), (80, 1), (1, 1), (112, 112), (150, 150),
                      (13, 9), (500, 47), (1080, 1920)]


@pytest.mark.parametrize("shape", NO_LANDMARK_SHAPES)
def test_preprocess_face_no_landmarks_matches_pil(shape):
    """The port's PIL-free resize + pad against the JAX package's PIL one:
    within one uint8 count (it computes PIL's fixed-point arithmetic, so
    no value differs)."""
    from terran_tpu.face.recognition import (
        preprocess_face_no_landmarks as jax_preprocess,
    )

    image = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    got = preprocess_face_no_landmarks(image)
    assert got.dtype == torch.uint8 and got.shape == (112, 112, 3)
    exp = jax_preprocess(image)
    diff = np.abs(got.numpy().astype(np.int32) - exp.astype(np.int32))
    assert diff.max() <= 1
    assert int((diff > 0).sum()) == 0, f"{int((diff > 0).sum())} differ"


@pytest.mark.parametrize("size,new", [((50, 70), (99, 33)),
                                      ((7, 300), (2, 5)),
                                      ((1000, 1000), (997, 3))])
def test_resize_pil_bicubic_matches_pil(size, new):
    from PIL import Image

    image = np.random.default_rng(5).integers(0, 256, size + (3,),
                                              dtype=np.uint8)
    got = resize_pil_bicubic(torch.from_numpy(image), *new).numpy()
    exp = np.asarray(Image.fromarray(image).resize(new))
    np.testing.assert_array_equal(got, exp)


def test_preprocess_rejects_a_zero_side_like_pil():
    """A side that scales to 0 pixels: PIL's resize raises, so does the
    port."""
    from terran_tpu.face.recognition import (
        preprocess_face_no_landmarks as jax_preprocess,
    )

    image = np.zeros((3, 700, 3), np.uint8)
    with pytest.raises(ValueError, match="must be > 0"):
        jax_preprocess(image)
    with pytest.raises(ValueError, match="must be > 0"):
        preprocess_face_no_landmarks(image)


@pytest.mark.parametrize("count", [1, 3])
def test_no_landmarks_call_matches_jax(recognizer, jax_recognizer, scene,
                                       count):
    """``call(images)`` without faces: one (N, 512) array of the whole
    images' embeddings, as the JAX package returns."""
    images, _ = scene
    got = recognizer.call(images[:count])
    exp = jax_recognizer.call(images[:count])
    assert isinstance(got, np.ndarray) and got.shape == (count, 512)
    assert got.dtype == exp.dtype == np.float32
    np.testing.assert_allclose(got, exp, rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_no_landmarks_task_expansion(recognizer, scene):
    """The task API: a single image without faces gives its (512,)
    embedding, a list gives (N, 512), no images give an empty list."""
    images, _ = scene
    task = Recognition.__new__(Recognition)
    task.model = recognizer
    batch = task(images[:2])
    assert batch.shape == (2, 512)
    np.testing.assert_allclose(task(images[0]), batch[0], rtol=0, atol=1e-6)
    assert task([]) == []


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
