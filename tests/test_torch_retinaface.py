"""Port's RetinaFace, its weight conversion, anchors and decode vs the JAX
package, in float32 on the CPU.

Scores compare to atol 1e-5. Boxes and landmarks compare to rtol 1e-4
against the largest coordinate of their anchor (plus 1e-4): ``exp`` in the
decode differs by ulps between XLA and torch, the heads by float32
summation order, and a corner is a difference of a centre and a half
width of hundreds of pixels with random weights, so a corner near 0
carries the absolute error of its operands.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from terran_tpu.models import retinaface as jax_rf
from terran_tpu.utils.convert import convert_retinaface as jax_convert
from terran_tpu_torch.models import retinaface as rf
from terran_tpu_torch.models.layers import upsample2x_nearest
from terran_tpu_torch.utils.convert import convert_retinaface, params_from_jax
from torch_oracle import random_retinaface_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401

SHAPE = (2, 64, 96)


@pytest.fixture(scope="module")
def weights():
    sd = random_retinaface_state_dict(np.random.default_rng(3))
    return sd, jax_convert(sd)


@pytest.fixture(scope="module")
def images():
    n, h, w = SHAPE
    return np.random.default_rng(7).integers(
        0, 255, size=(n, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_outputs(weights, images):
    _, params = weights
    return jax_rf.RetinaFace().apply({"params": params}, jnp.asarray(images))


@pytest.fixture(scope="module")
def outputs(weights, images):
    sd, _ = weights
    model = rf.RetinaFace()
    model.load_state_dict(convert_retinaface(sd), strict=True)
    with torch.inference_mode():
        return model(torch.from_numpy(images))


def test_both_conversions_agree(weights):
    sd, params = weights
    direct = convert_retinaface(sd)
    via_jax = params_from_jax(params)
    assert direct.keys() == via_jax.keys()
    assert direct.keys() == rf.RetinaFace().state_dict().keys()
    for key in direct:
        assert direct[key].shape == rf.RetinaFace().state_dict()[key].shape
        assert torch.equal(direct[key], via_jax[key]), key


def test_convert_is_strict(weights):
    sd, _ = weights
    extra = dict(sd, **{"base.stray.weight": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="unconverted"):
        convert_retinaface(extra)


@pytest.mark.parametrize("height,width", [(64, 96), (416, 739), (37, 50)])
def test_anchors_and_cells_equal_jax(height, width):
    np.testing.assert_array_equal(rf.anchors_for_shape(height, width),
                                  jax_rf.anchors_for_shape(height, width))
    for got, exp in zip(rf.anchor_cell_meta(height, width),
                        jax_rf.anchor_cell_meta(height, width)):
        np.testing.assert_array_equal(got, exp)
        assert got.dtype == exp.dtype
    for stride in rf.FEATURE_STRIDES:
        np.testing.assert_array_equal(rf.anchor_reference(stride),
                                      jax_rf.anchor_reference(stride))


def test_forward_matches_jax(outputs, jax_outputs):
    for stride in (8, 16, 32):
        for got, exp in zip(outputs[stride], jax_outputs[stride]):
            exp = np.asarray(exp)
            assert got.shape == exp.shape
            scale = np.abs(exp).max()
            assert np.abs(got.numpy() - exp).max() <= 1e-5 * max(scale, 1.0)


def test_decode_matches_jax(outputs, jax_outputs):
    _, h, w = SHAPE
    anchors = rf.anchors_for_shape(h, w)
    got = rf.decode_outputs(outputs, torch.from_numpy(anchors))
    exp = jax_rf.decode_outputs(jax_outputs, anchors)
    scores, boxes, landmarks = (t.numpy() for t in got)
    np.testing.assert_allclose(scores, np.asarray(exp[0]), atol=1e-5,
                               rtol=0)
    assert_close_per_anchor(boxes, np.asarray(exp[1]))
    assert_close_per_anchor(landmarks, np.asarray(exp[2]))
    assert landmarks.shape == (SHAPE[0], anchors.shape[0], 5, 2)


def assert_close_per_anchor(got, exp, rtol=1e-4, atol=1e-4):
    """|got - exp| <= rtol * (largest |coordinate| of the anchor) + atol."""
    n, a = exp.shape[:2]
    scale = np.abs(exp.reshape(n, a, -1)).max(axis=-1)
    err = np.abs(got - exp).reshape(n, a, -1).max(axis=-1)
    assert got.shape == exp.shape
    assert (err <= rtol * scale + atol).all(), float((err / scale).max())


def test_decode_same_inputs_is_exact_up_to_exp(jax_outputs):
    """On the same head outputs the decode differs only through exp: the
    scores and the landmarks (no exp) are equal to a few ulps."""
    _, h, w = SHAPE
    anchors = rf.anchors_for_shape(h, w)
    heads = {s: tuple(torch.from_numpy(np.array(t)) for t in v)
             for s, v in jax_outputs.items()}
    scores, _, landmarks = rf.decode_outputs(heads, torch.from_numpy(anchors))
    exp = jax_rf.decode_outputs(jax_outputs, anchors)
    np.testing.assert_allclose(scores.numpy(), np.asarray(exp[0]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(landmarks.numpy(), np.asarray(exp[2]),
                               rtol=1e-6, atol=1e-5)


def test_upsample_matches_jax():
    from terran_tpu.models.layers import upsample2x_nearest as jax_up

    x = np.random.default_rng(0).normal(size=(2, 3, 5, 4)).astype(np.float32)
    got = upsample2x_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), 5, 9)
    exp = np.asarray(jax_up(jnp.asarray(x), 5, 9))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), exp)
