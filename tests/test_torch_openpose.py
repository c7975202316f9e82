"""Port's BodyPoseModel and weight conversion vs the JAX model."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from terran_tpu.models.openpose import BodyPoseModel as JaxBodyPoseModel
from terran_tpu.utils.convert import convert_openpose as jax_convert
from terran_tpu_torch.models.openpose import BodyPoseModel
from terran_tpu_torch.utils.convert import convert_openpose, params_from_jax
from torch_oracle import random_openpose_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    sd = random_openpose_state_dict(np.random.default_rng(2))
    return sd, jax_convert(sd)


@pytest.fixture(scope="module")
def jax_outputs(weights):
    _, params = weights
    rng = np.random.default_rng(4)
    images = rng.integers(0, 255, size=(1, 48, 64, 3)).astype(np.float32)
    x = images / 255.0 - 0.5
    paf, heat = JaxBodyPoseModel().apply({"params": params}, jnp.asarray(x))
    return x, np.asarray(paf), np.asarray(heat)


def test_both_conversions_agree(weights):
    sd, params = weights
    direct = convert_openpose(sd)
    via_jax = params_from_jax(params)
    assert direct.keys() == via_jax.keys()
    assert direct.keys() == BodyPoseModel().state_dict().keys()
    for key in direct:
        assert torch.equal(direct[key], via_jax[key]), key


def test_convert_is_strict(weights):
    sd, _ = weights
    extra = dict(sd, **{"model0.stray.weight": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="unconverted"):
        convert_openpose(extra)


@pytest.mark.parametrize("source", ["reference_pth", "jax_params"])
def test_forward_matches_jax(source, weights, jax_outputs):
    sd, params = weights
    x, exp_paf, exp_heat = jax_outputs
    state = (convert_openpose(sd) if source == "reference_pth"
             else params_from_jax(params))
    model = BodyPoseModel()
    model.load_state_dict(state, strict=True)
    with torch.inference_mode():
        paf, heat = model(torch.from_numpy(x))
    assert paf.shape == (1, 6, 8, 38)
    assert heat.shape == (1, 6, 8, 19)
    np.testing.assert_allclose(paf.numpy(), exp_paf, atol=2e-4)
    np.testing.assert_allclose(heat.numpy(), exp_heat, atol=2e-4)
