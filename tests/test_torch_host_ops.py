"""The port's host resize and face warps vs the JAX package's.

The 'host' transfer plan resizes and warps on the host, uint8 out. The
port keeps its own copies of the JAX package's numpy warp and its OpenCV
forms, held equal here bit for bit; its 'exact' resize is its own
bilinear on the CPU, held bit for bit to ``resize_bilinear_u8_torch``.
"""

import numpy as np
import pytest
import torch

from terran_tpu.ops import resize as jax_resize
from terran_tpu.ops import warp as jax_warp
from terran_tpu_torch.ops.resize import (
    resize_bilinear_u8_cv2, resize_bilinear_u8_host,
)
from terran_tpu_torch.ops.warp import (
    ARCFACE_TEMPLATE, alignment_matrices, warp_affine_batch,
    warp_affine_u8_batch_cv2, warp_affine_u8_batch_numpy,
)
from torch_port_fixtures import single_torch_thread  # noqa: F401

FRAME = (60, 80, 3)


def rotated_faces(rng, count):
    """Landmarks of the template rotated, scaled and moved inside the
    frame."""
    out = []
    for angle in rng.uniform(-np.pi, np.pi, count):
        rot = np.array([[np.cos(angle), -np.sin(angle)],
                        [np.sin(angle), np.cos(angle)]])
        centred = ARCFACE_TEMPLATE - ARCFACE_TEMPLATE.mean(axis=0)
        out.append(centred @ rot.T * rng.uniform(0.2, 0.5)
                   + rng.uniform((15, 15), (65, 45)))
    return np.asarray(out, np.float32)


def case(name, rng):
    """(image, (M, 2, 3) float32 matrices) of one warp case."""
    image = rng.integers(0, 256, FRAME, dtype=np.uint8)
    if name == "random":
        lmks = rng.uniform((0, 0), (80, 60), (6, 5, 2))
    elif name == "rotated":
        lmks = rotated_faces(rng, 6)
    elif name == "out_of_frame":
        lmks = rng.uniform((-40, -40), (120, 100), (6, 5, 2))
    elif name == "tiny_source":
        image = rng.integers(0, 256, (1, 3, 3), dtype=np.uint8)
        lmks = rng.uniform(-2, 4, (4, 5, 2))
    elif name == "non_finite":
        mats = alignment_matrices(rng.uniform((0, 0), (80, 60), (5, 5, 2)))
        mats[1, 0, 0] = np.nan
        mats[2, 1, 2] = np.inf
        mats[3] = -np.inf
        return image, mats
    return image, alignment_matrices(np.asarray(lmks, np.float32))


CASES = ["random", "rotated", "out_of_frame", "tiny_source", "non_finite"]


@pytest.mark.parametrize("name", CASES)
def test_numpy_warp_equals_jax_numpy_warp(name):
    image, mats = case(name, np.random.default_rng(CASES.index(name)))
    got = warp_affine_u8_batch_numpy(image, mats)
    expected = jax_warp.warp_affine_u8_batch_numpy(image, mats)
    assert got.dtype == np.uint8 and got.shape == (len(mats), 112, 112, 3)
    np.testing.assert_array_equal(got, expected)
    if name == "non_finite":
        assert not got[3].any()


@pytest.mark.parametrize("name", CASES)
def test_numpy_warp_equals_the_port_warp_rounded(name):
    """On the CPU the numpy twin is the port's own per-pixel warp, rounded:
    the same float32 operations, one at a time."""
    image, mats = case(name, np.random.default_rng(CASES.index(name)))
    got = warp_affine_u8_batch_numpy(image, mats)
    expected = torch.round(warp_affine_batch(torch.from_numpy(image), mats))
    np.testing.assert_array_equal(got, expected.numpy().astype(np.uint8))


@pytest.mark.parametrize("name", CASES)
def test_cv2_warp_equals_jax_cv2_warp(name):
    image, mats = case(name, np.random.default_rng(CASES.index(name)))
    got = warp_affine_u8_batch_cv2(image, mats, out_h=112, out_w=96)
    expected = jax_warp.warp_affine_u8_batch_cv2(image, mats, out_h=112,
                                                 out_w=96)
    np.testing.assert_array_equal(got, expected)
    if name == "random":  # OpenCV's fixed point: within one count
        twin = warp_affine_u8_batch_numpy(image, mats, out_h=112, out_w=96)
        assert np.abs(got.astype(int) - twin.astype(int)).max() <= 1


SIZES = [(37, 53), (30, 40), (60, 80), (75, 100), (121, 161)]


@pytest.mark.parametrize("size", SIZES)
def test_exact_host_resize_equals_torch_twin(size):
    frames = np.random.default_rng(sum(size)).integers(
        0, 256, (2,) + FRAME, dtype=np.uint8)
    got = resize_bilinear_u8_host(frames, *size)
    expected = jax_resize.resize_bilinear_u8_torch(frames, *size)
    assert got.dtype == np.uint8 and got.shape == (2,) + size + (3,)
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("size", SIZES)
def test_cv2_resize_equals_jax_cv2_resize(size):
    frames = np.random.default_rng(sum(size)).integers(
        0, 256, (2,) + FRAME, dtype=np.uint8)
    got = resize_bilinear_u8_cv2(frames, *size)
    np.testing.assert_array_equal(
        got, jax_resize.resize_bilinear_u8_cv2(frames, *size))
    exact = resize_bilinear_u8_host(frames, *size)
    assert np.abs(got.astype(int) - exact.astype(int)).max() <= 1
