"""The port's int8 models and the task APIs' int8 branches against the
JAX package's ``apply_int8``, on the CPU, float32, on the same weights
carried across (``params_from_jax`` of the JAX ``quantize_params`` tree).

Measured agreement (these inputs):

- Int8BodyPoseModel: PAFs and heatmaps equal bit for bit (0 values
  differ) at (1, 48, 64) and (2, 96, 128) inputs. The tolerance of the
  native parity test is atol 2e-4 (``test_torch_openpose.py``); the int8
  model is held to equality.
- Int8FaceResNet100: the trunk, every value up to and with ``head_pre``,
  equals JAX's bit for bit; the float32 'embed' projection sums in
  another order, so the features differ by up to ~1e-6 of their largest
  magnitude and are held to the native test's 1e-5
  (``test_torch_arcface.py``), the unit embeddings to its atol 1e-4.

Equality needs the port to round where XLA rounds. XLA contracts the
affine ``x * scale + bias`` (ArcFace) and the dequantised conv plus
bias (OpenPose) into fused multiply-adds, and it computes the activation
scale ``max|x| / 127.0`` as ``max|x| * float32(1/127)``. Computed in two
roundings instead, the affine moved ~30% of a unit's values by one ulp,
which flipped .5 ties of the next ``round(x / xs)`` in every few units
(0.0025-0.008 at one unit's output, 4% of the features' largest
magnitude after 100 layers); the port computes both sums with one
rounding (``models/arcface.py::_Int8Affine``,
``models/openpose.py::_Int8ConvBias``).

The int8 models track the float32 ones as the JAX package's own int8
tests require (cosine > 0.98, correlation > 0.999), and the task APIs'
int8 branches give the JAX task APIs' embeddings of the same crops
(atol 1e-4, the native task test's) and pose decode arrays (peak slots
and limb acceptance equal, scores to the native test's rtol 1e-4).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from terran_tpu.face.recognition import ArcFaceRecognizer as JaxRecognizer
from terran_tpu.models import arcface as jax_arcface
from terran_tpu.models import openpose as jax_openpose
from terran_tpu.ops.pose_decode import unpack_pose_outputs as jax_unpack
from terran_tpu.pose.openpose import OpenPoseEstimator as JaxEstimator
from terran_tpu.utils.convert import convert_arcface as jax_convert_arcface
from terran_tpu.utils.convert import convert_openpose as jax_convert_openpose
from terran_tpu_torch.face import Recognition
from terran_tpu_torch.face.recognition import ArcFaceRecognizer
from terran_tpu_torch.models import arcface, openpose
from terran_tpu_torch.ops.pose_decode import unpack_pose_outputs
from terran_tpu_torch.ops.warp import ARCFACE_TEMPLATE
from terran_tpu_torch.pose import Estimation
from terran_tpu_torch.pose.openpose import OpenPoseEstimator
from terran_tpu_torch.utils.convert import (
    convert_arcface, convert_openpose, params_from_jax,
)
from torch_oracle import random_arcface_state_dict, random_openpose_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401

FEATURE_RTOL = 1e-5  # of the largest magnitude, as test_torch_arcface.py
EMB_ATOL = 1e-4
POSE_SIDE = 48


@pytest.fixture(scope="module")
def arcface_state():
    return random_arcface_state_dict(np.random.default_rng(7))


@pytest.fixture(scope="module")
def arcface_tree(arcface_state):
    return jax_arcface.quantize_params(jax_convert_arcface(arcface_state))


@pytest.fixture(scope="module")
def openpose_state():
    return random_openpose_state_dict(np.random.default_rng(5))


@pytest.fixture(scope="module")
def openpose_tree(openpose_state):
    return jax_openpose.quantize_params(jax_convert_openpose(openpose_state))


@pytest.fixture(scope="module")
def crops():
    return np.random.default_rng(13).integers(
        0, 255, (2, 112, 112, 3)).astype(np.float32)


def jax_trunk(qparams, x):
    """``apply_int8`` up to and with ``head_pre``, with the JAX package's
    own layer functions."""
    dt = jnp.float32
    x = ((x - jax_arcface.PREPROC_MEAN) * jax_arcface.PREPROC_STD).astype(dt)
    x = jax_arcface._quant_conv_affine(qparams["initial"], x, 1, 1, dt)
    x = jax_arcface._prelu(qparams["initial_prelu"], x)
    for stage_idx, units in enumerate(jax_arcface.UNITS_PER_STAGE):
        for unit_idx in range(units):
            p = qparams[f"stage{stage_idx}_unit{unit_idx}"]
            stride = 2 if unit_idx == 0 else 1
            body = jax_arcface._affine(p["pre"], x)
            body = jax_arcface._quant_conv_affine(p["conv1"], body, 1, 1, dt)
            body = jax_arcface._prelu(p["prelu"], body)
            body = jax_arcface._quant_conv_affine(p["conv2"], body, stride,
                                                  1, dt)
            shortcut = (jax_arcface._quant_conv_affine(
                p["shortcut"], x, stride, 0, dt) if unit_idx == 0 else x)
            x = body + shortcut
    return jax_arcface._affine(qparams["head_pre"], x)


def int8_arcface(state):
    model = arcface.Int8FaceResNet100()
    model.load_state_dict(state, strict=True)
    return model.eval()


def test_int8_arcface_matches_jax(arcface_tree, crops):
    model = int8_arcface(params_from_jax(arcface_tree))
    trunk = {}
    model.head_pre.register_forward_hook(
        lambda module, args, out: trunk.setdefault("out", out))
    with torch.inference_mode():
        feats = model(torch.from_numpy(crops))
    np.testing.assert_array_equal(
        trunk["out"].numpy(),
        np.asarray(jax.jit(jax_trunk)(arcface_tree, crops)))

    exp = np.asarray(jax.jit(jax_arcface.apply_int8)(arcface_tree, crops))
    assert feats.shape == (2, 512) and feats.dtype == torch.float32
    err = np.abs(feats.numpy() - exp).max()
    assert err <= FEATURE_RTOL * np.abs(exp).max(), err
    np.testing.assert_allclose(
        arcface.normalize_embeddings(feats).numpy(),
        np.asarray(jax_arcface.normalize_embeddings(exp)), rtol=0,
        atol=EMB_ATOL)


def test_own_quantisation_gives_the_carried_model(arcface_state,
                                                  arcface_tree, crops):
    x = torch.from_numpy(crops[:1])
    with torch.inference_mode():
        own = int8_arcface(arcface.quantize_params(
            convert_arcface(arcface_state)))(x)
        carried = int8_arcface(params_from_jax(arcface_tree))(x)
    assert torch.equal(own, carried)


@pytest.mark.parametrize("shape", [(1, 48, 64, 3), (2, 96, 128, 3)])
def test_int8_openpose_matches_jax(openpose_tree, shape):
    x = (np.random.default_rng(1).integers(0, 255, shape) / 255.0
         - 0.5).astype(np.float32)
    model = openpose.Int8BodyPoseModel()
    model.load_state_dict(params_from_jax(openpose_tree), strict=True)
    with torch.inference_mode():
        paf, heat = model(torch.from_numpy(x))
    exp_paf, exp_heat = jax.jit(jax_openpose.apply_int8)(openpose_tree, x)
    assert paf.shape == shape[:1] + (shape[1] // 8, shape[2] // 8, 38)
    assert heat.shape == paf.shape[:3] + (19,)
    np.testing.assert_array_equal(paf.numpy(), np.asarray(exp_paf))
    np.testing.assert_array_equal(heat.numpy(), np.asarray(exp_heat))


def test_int8_models_track_float32(arcface_state, openpose_state, crops):
    """The JAX package's own bounds for its int8 trunks
    (tests/test_arcface_int8.py, tests/test_openpose_int8.py), on the
    port's models against the port's float32 ones."""
    native = arcface.FaceResNet100()
    state = convert_arcface(arcface_state)
    native.load_state_dict(state, strict=True)
    with torch.inference_mode():
        ref = arcface.normalize_embeddings(native(torch.from_numpy(crops)))
        out = arcface.normalize_embeddings(int8_arcface(
            arcface.quantize_params(state))(torch.from_numpy(crops)))
    cos = (ref * out).sum(-1)
    assert (cos > 0.98).all(), cos

    state = convert_openpose(openpose_state)
    native = openpose.BodyPoseModel()
    native.load_state_dict(state, strict=True)
    int8 = openpose.Int8BodyPoseModel()
    int8.load_state_dict(openpose.quantize_params(state), strict=True)
    x = torch.from_numpy((np.random.default_rng(2).integers(
        0, 255, (1, 48, 64, 3)) / 255.0 - 0.5).astype(np.float32))
    with torch.inference_mode():
        for a, b in zip(native(x), int8(x)):
            corr = np.corrcoef(a.numpy().ravel(), b.numpy().ravel())[0, 1]
            assert corr > 0.999, corr


def test_int8_bf16_models_run(arcface_state, crops):
    """Under bf16 the leaves and the activations are bf16, the scales and
    the 'embed' head float32; the features stay close to float32 int8."""
    state = convert_arcface(arcface_state)
    model = arcface.Int8FaceResNet100(torch.bfloat16)
    model.load_state_dict(arcface.quantize_params(state, torch.bfloat16),
                          strict=True)
    assert model.embed.weight.dtype == torch.float32
    assert model.initial.scale.dtype == torch.bfloat16
    with torch.inference_mode():
        got = arcface.normalize_embeddings(model(torch.from_numpy(crops)))
        ref = arcface.normalize_embeddings(int8_arcface(
            arcface.quantize_params(state))(torch.from_numpy(crops)))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got * ref).sum(-1) > 0.98).all()


def face_at(cx, cy, size=60.0):
    """A detection whose landmarks are the template scaled and moved."""
    lmk = (ARCFACE_TEMPLATE - ARCFACE_TEMPLATE.mean(axis=0)) * (
        size / 112.0) + (cx, cy)
    return {"bbox": np.array([cx - size / 2, cy - size / 2, cx + size / 2,
                              cy + size / 2], np.int32),
            "landmarks": lmk.astype(np.int32), "score": 0.99}


def test_recognizer_int8_matches_jax(arcface_state):
    """``ArcFaceRecognizer(embed_precision='int8')``, quantised from the
    float32 weights it was given, with and without landmarks."""
    rng = np.random.default_rng(21)
    images = [rng.integers(0, 255, (160, 200, 3), dtype=np.uint8),
              rng.integers(0, 255, (90, 120, 3), dtype=np.uint8)]
    faces = [[face_at(100, 80), face_at(60, 60, 40.0)], []]
    port = ArcFaceRecognizer(params=convert_arcface(arcface_state),
                             device="cpu", embed_precision="int8")
    assert isinstance(port.model, arcface.Int8FaceResNet100)
    jax_rec = JaxRecognizer(params=jax_convert_arcface(arcface_state),
                            embed_precision="int8")
    # The two packages' warps may round a crop pixel next to a .5 tie one
    # count apart (test_torch_recognition_api.py), and the int8 trunk
    # moves a unit embedding by ~7e-3 for one such count: the packages
    # embed the port's crops.
    crops = port.align(images[0], faces[0])
    np.testing.assert_allclose(port._embed(crops), jax_rec._embed(crops),
                               rtol=0, atol=EMB_ATOL)
    per_image = port.call(images, faces)
    assert [g.shape for g in per_image] == [(2, 512), (0, 512)]
    np.testing.assert_array_equal(per_image[0], port._embed(crops))
    # Without landmarks both packages resize with PIL's arithmetic, to
    # equal crops.
    got, exp = port.call(images), jax_rec.call(images)
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, exp, rtol=0, atol=EMB_ATOL)
    # The generic task class hands the keyword on.
    task = Recognition(device="cpu", params=convert_arcface(arcface_state),
                       embed_precision="int8")
    np.testing.assert_array_equal(task(images[0], faces[0]), per_image[0])


def test_estimator_int8_matches_jax(openpose_state):
    """``OpenPoseEstimator(pose_precision='int8')``: the decode arrays at
    K=8 as the JAX estimator's (images at the short side, so the resize
    is the identity), and the call keeps the reference contract."""
    images = np.random.default_rng(5).integers(
        0, 255, (2, POSE_SIDE, 64, 3), dtype=np.uint8)
    port = OpenPoseEstimator(params=convert_openpose(openpose_state),
                             device="cpu", short_side=POSE_SIDE, max_peaks=8,
                             max_escalations=0, pose_precision="int8")
    assert isinstance(port.model, openpose.Int8BodyPoseModel)
    jax_est = JaxEstimator(params=jax_convert_openpose(openpose_state),
                           short_side=POSE_SIDE, max_peaks=8,
                           max_escalations=0, pose_precision="int8")
    peaks, limbs = jax_est._decode_fn(*images.shape[1:3])(jax_est.params,
                                                          images)
    exp = jax_unpack(np.asarray(peaks), np.asarray(limbs))
    peaks, limbs = port._decode_fn()(torch.from_numpy(images))
    c_g, s_g, v_g, _, acc_g, o_g = unpack_pose_outputs(peaks.numpy(),
                                                        limbs.numpy())
    c_e, s_e, v_e, _, acc_e, o_e = exp
    # As test_torch_pose_api.py holds the native decode: the heatmaps are
    # equal, the x8 upsample sums in another order.
    np.testing.assert_array_equal(v_g, v_e)
    np.testing.assert_array_equal(o_g, o_e)
    np.testing.assert_array_equal(np.where(v_g[..., None], c_g, 0),
                                  np.where(v_e[..., None], c_e, 0))
    np.testing.assert_allclose(s_g, s_e, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(acc_g, acc_e)
    assert v_g.any(), "no peaks to compare"
    out = Estimation(device="cpu", params=convert_openpose(openpose_state),
                     short_side=POSE_SIDE, max_peaks=8, max_escalations=0,
                     pose_precision="int8")(images)
    assert len(out) == 2
    for people in out:
        for person in people:
            assert person["keypoints"].shape == (18, 3)
