"""Sampled limb scores: ``sample_bicubic`` and ``limb_scores_sampled``.

Against the materialised form (``upsample_bicubic`` then ``limb_scores``)
bit for bit, and against the JAX package's sampled functions: sampled
values to rtol 1e-6 / atol 1e-7 (XLA may contract a multiply-add into an
FMA), as test_torch_upsample.py compares the FIR; accept flags equal and
``reg`` to rtol 1e-5 / atol 1e-6 (its 10-sample sum and division add a
few ulps).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from terran_tpu.ops.pose_decode import (
    limb_scores_sampled as jax_limb_scores_sampled,
)
from terran_tpu.ops.upsample import sample_bicubic as jax_sample_bicubic
from terran_tpu_torch.ops.pose_decode import (
    COCO_18, find_peaks, limb_scores, limb_scores_sampled,
)
from terran_tpu_torch.ops.upsample import sample_bicubic, upsample_bicubic
from torch_port_fixtures import single_torch_thread  # noqa: F401
from test_torch_pose_decode import smooth_fields


@pytest.mark.parametrize("shape,factor", [((3, 7, 9), 8), ((2, 23, 40), 8),
                                          ((1, 5, 6), 3)])
def test_sample_bicubic_is_the_upsampled_field(shape, factor):
    rng = np.random.default_rng(sum(shape))
    maps = rng.normal(size=shape).astype(np.float32)
    m, h, w = shape
    ys = rng.integers(0, h * factor, (m, 5, 4))
    xs = rng.integers(0, w * factor, (m, 5, 4))
    ys[:, 0, 0], xs[:, 0, 0] = 0, w * factor - 1  # both corners of a row
    ys[:, 0, 1], xs[:, 0, 1] = h * factor - 1, 0
    got = sample_bicubic(torch.from_numpy(maps), factor,
                         torch.from_numpy(ys), torch.from_numpy(xs))
    field = upsample_bicubic(torch.from_numpy(maps)[..., None], factor)[..., 0]
    expected = field[torch.arange(m)[:, None, None], torch.from_numpy(ys),
                     torch.from_numpy(xs)]
    assert torch.equal(got, expected)
    jax_got = np.asarray(jax_sample_bicubic(
        jnp.asarray(maps), factor, jnp.asarray(ys, jnp.int32),
        jnp.asarray(xs, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), jax_got, rtol=1e-6, atol=1e-7)


def peaks_on(heat, max_peaks):
    coords, _, valid, _ = find_peaks(
        upsample_bicubic(torch.from_numpy(heat[..., :COCO_18.parts]), 8), 0.1,
        max_peaks)
    return coords, valid


@pytest.mark.parametrize("k", [16, 6])
def test_limb_scores_sampled_equal_materialised(k):
    """The model-like case: peaks of smooth heatmaps, at the pipeline's
    K=16 among others, a batch of two, bit for bit."""
    rng = np.random.default_rng(k)
    fields = [smooth_fields(rng, 23, 40) for _ in range(2)]
    heat = np.stack([f[0] for f in fields])
    pafs = torch.from_numpy(np.stack([f[1] for f in fields]))
    coords, valid = peaks_on(heat, k)
    reg_s, acc_s = limb_scores_sampled(pafs, 8, coords, valid, 0.05)
    reg_m, acc_m = limb_scores(upsample_bicubic(pafs, 8), coords, valid,
                               0.05)
    assert torch.equal(reg_s, reg_m) and torch.equal(acc_s, acc_m)
    assert acc_m.any(), "no accepted limbs to compare"


@pytest.mark.parametrize("seed", range(3))
def test_limb_scores_sampled_match_jax(seed):
    rng = np.random.default_rng(seed)
    h, w, k, factor = 24, 30, 6, 8
    pafs = rng.normal(scale=0.3, size=(h, w, 38)).astype(np.float32)
    coords = rng.integers(0, min(h, w) * factor - 1,
                          size=(COCO_18.parts, k, 2)).astype(np.int32)
    valid = rng.uniform(size=(COCO_18.parts, k)) < 0.7
    reg, accept = limb_scores_sampled(torch.from_numpy(pafs), factor,
                                      torch.from_numpy(coords),
                                      torch.from_numpy(valid), 0.05)
    reg_e, accept_e = map(np.asarray, jax_limb_scores_sampled(
        jnp.asarray(pafs), factor, jnp.asarray(coords), jnp.asarray(valid),
        0.05))
    np.testing.assert_array_equal(accept.numpy(), accept_e)
    np.testing.assert_allclose(reg.numpy(), reg_e, rtol=1e-5, atol=1e-6)
    reg_m, accept_m = limb_scores(upsample_bicubic(
        torch.from_numpy(pafs)[None], factor)[0], torch.from_numpy(coords),
        torch.from_numpy(valid), 0.05)
    assert torch.equal(reg, reg_m) and torch.equal(accept, accept_m)
