"""Port's FaceResNet100 and its weight conversion vs the JAX model, in
float32 on the CPU.

Unnormalised features compare within 1e-5 of their largest magnitude
(float32 conv sums in another order through 100 layers); normalised
embeddings within atol 1e-4.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from terran_tpu.models import arcface as jax_arcface
from terran_tpu.utils.convert import convert_arcface as jax_convert
from terran_tpu_torch.models import arcface
from terran_tpu_torch.utils.convert import convert_arcface, params_from_jax
from torch_oracle import random_arcface_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    sd = random_arcface_state_dict(np.random.default_rng(12))
    return sd, jax_convert(sd)


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(13).integers(
        0, 255, size=(2, 112, 112, 3)).astype(np.float32)


def test_both_conversions_agree(weights):
    sd, params = weights
    direct = convert_arcface(sd)
    via_jax = params_from_jax(params)
    reference = arcface.FaceResNet100().state_dict()
    assert direct.keys() == via_jax.keys() == reference.keys()
    for key in direct:
        assert direct[key].shape == reference[key].shape, key
        assert torch.equal(direct[key], via_jax[key]), key


def test_convert_is_strict(weights):
    sd, _ = weights
    extra = dict(sd, **{"stages.0.0.stray.weight": np.zeros(1, np.float32)})
    with pytest.raises(ValueError, match="unconverted"):
        convert_arcface(extra)


def test_forward_and_embeddings_match_jax(weights, crops):
    sd, params = weights
    model = arcface.FaceResNet100()
    model.load_state_dict(convert_arcface(sd), strict=True)
    with torch.inference_mode():
        feats = model(torch.from_numpy(crops))
        emb = arcface.normalize_embeddings(feats)
    exp = np.asarray(jax.jit(jax_arcface.FaceResNet100().apply)(
        {"params": params}, jnp.asarray(crops)))
    assert feats.shape == (2, 512) and feats.dtype == torch.float32
    err = np.abs(feats.numpy() - exp).max()
    assert err <= 1e-5 * np.abs(exp).max(), err
    np.testing.assert_allclose(
        emb.numpy(), np.asarray(jax_arcface.normalize_embeddings(exp)),
        rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(emb.numpy(), axis=1), 1.0,
                               rtol=1e-6)


def test_normalize_embeddings_matches_jax():
    x = np.random.default_rng(0).normal(size=(4, 512)).astype(np.float32)
    x[3] = 0.0
    got = arcface.normalize_embeddings(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_arcface.normalize_embeddings(jnp.asarray(x))),
        rtol=1e-6, atol=1e-7)
    assert not got[3].any()


def test_embed_stays_float32_under_bf16(weights):
    from terran_tpu_torch.face.recognition import ArcFaceRecognizer

    rec = ArcFaceRecognizer(params=convert_arcface(weights[0]), device="cpu",
                            compute_dtype=torch.bfloat16)
    assert rec.model.embed.weight.dtype == torch.float32
    assert rec.model.initial.conv.weight.dtype == torch.bfloat16
