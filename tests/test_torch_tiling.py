"""The port's tiled detection (``terran_tpu_torch.ops.tiling``), float32
on the CPU.

The cases of ``tests/test_tiling.py`` run against the port; then
``extract_tiles_device`` on CPU tensors against the JAX function, and
``TiledDetector`` against the JAX class on a 12-tile frame with the same
random RetinaFace weights, within the detection tolerance of
``tests/test_torch_detection_api.py``: the same faces in the same order,
scores within 1e-5, boxes and landmarks within 1e-3 plus 2e-5 of the
row's largest coordinate.
"""

import numpy as np
import pytest
import torch

from terran_tpu.face.detection import RetinaFaceDetector as JaxDetector
from terran_tpu.ops import tiling as jax_tiling
from terran_tpu.utils.convert import convert_retinaface as jax_convert
from terran_tpu_torch.face.detection import RetinaFaceDetector
from terran_tpu_torch.ops import tiling
from terran_tpu_torch.ops.nms import iou_matrix
from terran_tpu_torch.ops.tiling import (
    TiledDetector, extract_tiles, extract_tiles_device, tile_layout,
)
from terran_tpu_torch.utils.convert import convert_retinaface
from torch_oracle import random_retinaface_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401


@pytest.fixture
def rng():
    return np.random.default_rng(0)


# tests/test_tiling.py's cases, on the port.

@pytest.mark.parametrize("h,w,tile,overlap", [
    (2160, 3840, 1024, 256), (500, 700, 256, 64), (100, 100, 256, 64)])
def test_tile_layout_covers_image(h, w, tile, overlap):
    origins = tile_layout(h, w, tile, overlap)
    assert origins == jax_tiling.tile_layout(h, w, tile, overlap)
    covered = np.zeros((h, w), bool)
    for y, x in origins:
        covered[y: y + tile, x: x + tile] = True
        if h > tile:
            assert y + tile <= h
        if w > tile:
            assert x + tile <= w
    assert covered.all()


def test_tile_layout_overlap_guarantee_and_4k_count():
    origins = tile_layout(2000, 2000, tile=1024, overlap=256)
    ys = sorted({y for y, _ in origins})
    for a, b in zip(ys, ys[1:]):
        assert b - a <= 1024 - 256
    assert len(tile_layout(2160, 3840, 1024, 256)) == 15
    with pytest.raises(ValueError):
        tile_layout(100, 100, tile=64, overlap=64)


def test_extract_tiles_contents(rng):
    image = rng.integers(0, 255, (300, 500, 3), dtype=np.uint8)
    origins = tile_layout(300, 500, tile=256, overlap=64)
    tiles = extract_tiles(image, origins, tile=256)
    assert tiles.shape == (len(origins), 256, 256, 3)
    for (y, x), t in zip(origins, tiles):
        np.testing.assert_array_equal(t, image[y: y + 256, x: x + 256])
    np.testing.assert_array_equal(
        tiles, jax_tiling.extract_tiles(image, origins, tile=256))


@pytest.mark.parametrize("shape", [(300, 500, 3), (100, 90, 3),
                                   (256, 100, 3), (90, 256, 1)])
def test_extract_tiles_device_matches_host_and_jax(rng, shape):
    """Regular and zero-padded frames, on CPU tensors: equal to the host
    extraction and to the JAX function, dtype kept."""
    image = rng.integers(0, 255, shape, dtype=np.uint8)
    origins = tile_layout(shape[0], shape[1], tile=256, overlap=64)
    got = extract_tiles_device(torch.from_numpy(image), origins, tile=256)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  extract_tiles(image, origins, tile=256))
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jax_tiling.extract_tiles_device(image, origins, 256)))


def test_extract_tiles_device_clamps_origins_like_jax(rng):
    image = rng.integers(0, 255, (300, 500, 3), dtype=np.uint8)
    origins = [(250, 400), (200, 0), (299, 499)]
    np.testing.assert_array_equal(
        extract_tiles_device(image, origins, tile=128).numpy(),
        np.asarray(jax_tiling.extract_tiles_device(image, origins, 128)))


@pytest.fixture(scope="module")
def state_dict():
    return random_retinaface_state_dict(np.random.default_rng(13))


@pytest.fixture(scope="module")
def detector(state_dict):
    return RetinaFaceDetector(params=convert_retinaface(state_dict),
                              device="cpu", top_k=64)


@pytest.fixture(scope="module")
def jax_detector(state_dict):
    return JaxDetector(params=jax_convert(state_dict), top_k=64)


def test_single_tile_equals_direct(detector):
    """An image that fits one tile gives the direct result, within the
    detection tolerance: the CPU's float32 forward of the sliced tile and
    of the frame can differ in the last bits."""
    image = np.random.default_rng(1).integers(0, 255, (128, 128, 3),
                                              dtype=np.uint8)
    direct = detector.call(image[None])[0]
    got = TiledDetector(detector, tile=128, overlap=32)(image)
    assert len(got) == len(direct) and got
    assert_rows_close([g["bbox"] for g in got], [d["bbox"] for d in direct])
    np.testing.assert_allclose([g["score"] for g in got],
                               [d["score"] for d in direct], rtol=0,
                               atol=1e-5)


@pytest.fixture(scope="module")
def multi_tile():
    """A 256x384 frame: 12 tiles of 128 with 32 px overlaps."""
    return np.random.default_rng(2).integers(0, 255, (256, 384, 3),
                                             dtype=np.uint8)


def test_device_and_host_tiles_agree(detector, multi_tile):
    dev = TiledDetector(detector, tile=128, overlap=32, top_k=128)
    host = TiledDetector(detector, tile=128, overlap=32, top_k=128,
                         device_tiles=False)
    fd, fh = dev(multi_tile), host(multi_tile)
    assert len(fd) == len(fh) and fd
    for a, b in zip(fd, fh):
        np.testing.assert_array_equal(a["bbox"], b["bbox"])
        np.testing.assert_array_equal(a["score"], b["score"])


def test_multi_tile_global_coordinates(detector, multi_tile):
    faces = TiledDetector(detector, tile=128, overlap=32,
                          top_k=128)(multi_tile)
    assert isinstance(faces, list) and faces
    for face in faces:
        assert face["landmarks"].shape == (5, 2)
    scores = [float(f["score"]) for f in faces]
    assert scores == sorted(scores, reverse=True)
    boxes = torch.from_numpy(np.stack([f["bbox"] for f in faces]))
    ious = iou_matrix(boxes, boxes).numpy().copy()
    np.fill_diagonal(ious, 0.0)
    assert ious.max() <= 0.4 + 1e-5


def test_merge_runs_on_the_detector_device_at_a_pow2_bucket(
        detector, multi_tile, monkeypatch):
    """The global merge's candidates are tensors on the detector's device
    (a CUDA detector's merge launches the NMS kernels), padded to a power
    of two with -1 scores, at the fixed top_k."""
    seen = []
    merge = tiling.nms_fixed

    def spy(boxes, scores, *args, **kwargs):
        seen.append((boxes, scores, kwargs))
        return merge(boxes, scores, *args, **kwargs)

    monkeypatch.setattr(tiling, "nms_fixed", spy)
    faces = TiledDetector(detector, tile=128, overlap=32,
                          top_k=128)(multi_tile)
    assert len(seen) == 1 and faces
    boxes, scores, kwargs = seen[0]
    assert isinstance(boxes, torch.Tensor) and boxes.device == detector.device
    assert scores.device == detector.device
    bucket = boxes.shape[0]
    count = int((scores >= 0).sum())
    assert bucket & (bucket - 1) == 0 and bucket // 2 < count <= bucket
    assert (scores[count:] == -1).all()
    assert kwargs["top_k"] == 128


def test_no_faces_gives_an_empty_list(detector):
    black = np.zeros((200, 200, 3), np.uint8)
    assert TiledDetector(detector, tile=128, overlap=32)(
        black, threshold=1.1) == []


def test_tile_granularity_respects_pad_bucketing(state_dict):
    params = convert_retinaface(state_dict)
    pad_det = RetinaFaceDetector(params=params, device="cpu",
                                 bucketing="pad")
    with pytest.raises(ValueError, match="multiple of 64"):
        TiledDetector(pad_det, tile=992)
    TiledDetector(pad_det, tile=1024)
    exact_det = RetinaFaceDetector(params=params, device="cpu",
                                   bucketing="exact")
    TiledDetector(exact_det, tile=992)
    with pytest.raises(ValueError, match="multiple of 32"):
        TiledDetector(exact_det, tile=1000)


def assert_rows_close(got, exp):
    """|got - exp| <= 1e-3 + 2e-5 * (largest |coordinate| of the row)."""
    got = np.asarray(got, np.float32).reshape(len(exp), -1)
    exp = np.asarray(exp, np.float32).reshape(len(exp), -1)
    scale = np.abs(exp).max(axis=-1, keepdims=True)
    assert (np.abs(got - exp) <= 1e-3 + 2e-5 * scale).all()


@pytest.mark.parametrize("device_tiles", [True, False])
def test_tiled_detector_matches_jax(detector, jax_detector, multi_tile,
                                    device_tiles):
    kwargs = dict(tile=128, overlap=32, top_k=128, device_tiles=device_tiles)
    got = TiledDetector(detector, **kwargs)(multi_tile)
    exp = jax_tiling.TiledDetector(jax_detector, **kwargs)(multi_tile)
    assert len(got) == len(exp) and len(exp) > 4
    for key in ("bbox", "landmarks", "score"):
        g = np.stack([face[key] for face in got])
        e = np.stack([face[key] for face in exp])
        assert g.shape == e.shape and g.dtype == e.dtype, key
        if key == "score":
            np.testing.assert_allclose(g, e, rtol=0, atol=1e-5)
        else:
            assert_rows_close(g, e)
