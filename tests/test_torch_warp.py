"""Port's alignment (Umeyama, batched matrices) and affine warp vs the JAX
package, on the CPU.

The copied numpy solvers must give the JAX package's matrices exactly.
The warp must match the JAX ``warp_affine_batch`` within 1e-4 of the
0-255 pixel range (0.0255): both compute the same float32 expressions,
but XLA contracts the sample coordinate's multiply-adds into FMAs, which
moves a coordinate of ~100 px by an ulp (~8e-6) and a blended value by up
to that times a tap difference of 255. And it must match PIL's uint8
warp within one count (PIL in the test only).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from terran_tpu.ops import warp as jax_warp
from terran_tpu_torch.ops import warp
from torch_port_fixtures import single_torch_thread  # noqa: F401


def make_similarity(scale, angle, tx, ty):
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(3)
    m[:2, :2] = scale * np.array([[c, -s], [s, c]])
    m[:2, 2] = (tx, ty)
    return m


SIMILARITIES = [(1.0, 0.0, 0.0, 0.0), (0.5, 0.2, 5.0, -3.0),
                (2.0, -0.7, -10.0, 8.0), (0.8, 0.1, -20.0, -15.0)]


def test_template_is_the_jax_one():
    np.testing.assert_array_equal(warp.ARCFACE_TEMPLATE,
                                  jax_warp.ARCFACE_TEMPLATE)


@pytest.mark.parametrize("seed", range(3))
def test_umeyama_and_alignment_equal_jax(seed):
    rng = np.random.default_rng(seed)
    truth = make_similarity(rng.uniform(0.5, 2), rng.uniform(-1, 1),
                            *rng.uniform(-30, 30, 2))
    landmarks = ((truth[:2, :2] @ warp.ARCFACE_TEMPLATE.T).T + truth[:2, 2]
                 + rng.normal(scale=0.5, size=(5, 2))).astype(np.float32)
    np.testing.assert_array_equal(
        warp.umeyama(landmarks, warp.ARCFACE_TEMPLATE),
        jax_warp.umeyama(landmarks, jax_warp.ARCFACE_TEMPLATE))
    np.testing.assert_array_equal(warp.alignment_matrix(landmarks),
                                  jax_warp.alignment_matrix(landmarks))


def test_alignment_matrices_equal_jax():
    rng = np.random.default_rng(4)
    landmarks = (warp.ARCFACE_TEMPLATE[None] * rng.uniform(0.5, 3, (8, 1, 1))
                 + rng.uniform(0, 300, (8, 1, 2))
                 + rng.normal(scale=1.0, size=(8, 5, 2))).astype(np.float32)
    # A collinear (rank-deficient) and a mirrored face.
    landmarks[6] = np.stack([np.arange(5.0), 2 * np.arange(5.0)], axis=1)
    landmarks[7, :, 0] *= -1
    got = warp.alignment_matrices(landmarks)
    np.testing.assert_array_equal(got, jax_warp.alignment_matrices(landmarks))
    assert got.shape == (8, 2, 3) and got.dtype == np.float32


def inverses(similarities):
    return np.stack([np.linalg.inv(make_similarity(*s))[:2]
                     for s in similarities]).astype(np.float32)


@pytest.mark.parametrize("shape", [(80, 60, 3), (1, 7, 3), (9, 1, 3),
                                   (1, 1, 3), (2, 2, 3)])
def test_warp_batch_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    image = rng.integers(0, 255, size=shape, dtype=np.uint8)
    mats = inverses(SIMILARITIES)
    got = warp.warp_affine_batch(torch.from_numpy(image),
                                 torch.from_numpy(mats), out_h=56, out_w=48)
    exp = np.asarray(jax_warp.warp_affine_batch(image, mats, out_h=56,
                                                out_w=48))
    assert got.shape == exp.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=255e-4)
    # Rounded to uint8 counts, as the recognizer rounds its crops, nearly
    # all samples agree; the FMA shows only next to a .5 tie.
    assert (np.round(got.numpy()) == np.round(exp)).mean() > 0.99
    single = warp.warp_affine(torch.from_numpy(image), mats[1], 56, 48)
    assert torch.equal(single, got[1])


@pytest.mark.parametrize("shape,out", [((80, 60, 3), (56, 48)),
                                       ((1, 7, 3), (8, 6)),
                                       ((9, 1, 3), (8, 6)),
                                       ((1, 1, 3), (8, 6))])
def test_warp_within_one_count_of_pil(shape, out):
    rng = np.random.default_rng(7)
    image = rng.integers(0, 255, size=shape, dtype=np.uint8)
    out_h, out_w = out
    mats = inverses(SIMILARITIES[:3] if shape[0] > 2
                    else [(0.5, 0.3, 1.0, -0.5)])
    got = warp.warp_affine_batch(torch.from_numpy(image),
                                 torch.from_numpy(mats), out_h, out_w).numpy()
    for crop, inv in zip(got, mats):
        pil = Image.fromarray(image.squeeze(-1) if shape[-1] == 1
                              else image).transform(
            size=(out_w, out_h), method=Image.AFFINE, data=inv.flatten(),
            resample=Image.BILINEAR, fillcolor=0,
        )
        expected = np.asarray(pil).astype(np.float32)
        assert np.abs(crop - expected).max() <= 1.01
        assert np.abs(crop - expected).mean() < 0.5


def test_degenerate_matrix_fills_zero():
    image = np.full((20, 20, 3), 200, np.uint8)
    mats = np.full((1, 2, 3), np.nan, np.float32)
    got = warp.warp_affine_batch(torch.from_numpy(image),
                                 torch.from_numpy(mats), 8, 8)
    assert torch.equal(got, torch.zeros_like(got))
