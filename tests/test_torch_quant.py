"""The port's int8 quantisation (``terran_tpu_torch/models/quant.py``)
against the JAX package's (``terran_tpu/models/quant.py``), on the CPU.

Every comparison here is bit for bit, tolerance 0:

- the quantised weights of both models (int8 values, float32 scales, the
  leaves cast to bf16, the float32 'embed' head, the OpenPose biases)
  equal ``quantize_params`` of the JAX package, as it runs (outside any
  jit, so ``max|w| / 127.0`` is a true division);
- ``quant_conv`` equals the JAX ``quant_conv`` under ``jax.jit``, as the
  JAX models run it, for every distinct conv shape of both models (the
  first conv's K = 27, the stride-2 convs, the 1x1 shortcuts, the 7x7
  stage convs, N = 19 and 38), in float32 and bf16, including a case
  whose accumulators exceed 2**24 (their conversion to float32 rounds)
  and one whose activation maximum makes ``m * float32(1/127)``, XLA's
  rewrite of ``m / 127.0``, differ from the division;
- the eager im2col + ``torch._int_mm`` (which runs on this CPU too)
  equals the plain float64 conv, so the im2col indexing, the K and N
  padding and the row padding are held here; on the card,
  ``test_torch_quant_kernels.py`` holds csrc/quant_conv.cu's kernels to
  these eager passes.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from terran_tpu.models import arcface as jax_arcface
from terran_tpu.models import openpose as jax_openpose
from terran_tpu.models import quant as jax_quant
from terran_tpu.utils.convert import convert_arcface as jax_convert_arcface
from terran_tpu.utils.convert import convert_openpose as jax_convert_openpose
from terran_tpu_torch.models import arcface, openpose, quant
from terran_tpu_torch.utils.convert import (
    convert_arcface, convert_openpose, params_from_jax,
)
from torch_oracle import random_arcface_state_dict, random_openpose_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401

# Every distinct (cin, cout, kernel, stride, padding) of the two models
# (test_shapes_cover_both_models holds the list to the modules).
ARCFACE_SHAPES = [
    (3, 64, 3, 1, 1),
    (64, 64, 3, 1, 1), (64, 64, 3, 2, 1), (64, 64, 1, 2, 0),
    (64, 128, 3, 1, 1), (128, 128, 3, 2, 1), (64, 128, 1, 2, 0),
    (128, 128, 3, 1, 1),
    (128, 256, 3, 1, 1), (256, 256, 3, 2, 1), (128, 256, 1, 2, 0),
    (256, 256, 3, 1, 1),
    (256, 512, 3, 1, 1), (512, 512, 3, 2, 1), (256, 512, 1, 2, 0),
    (512, 512, 3, 1, 1),
]
OPENPOSE_SHAPES = [
    (3, 64, 3, 1, 1), (64, 64, 3, 1, 1), (64, 128, 3, 1, 1),
    (128, 128, 3, 1, 1), (128, 256, 3, 1, 1), (256, 256, 3, 1, 1),
    (256, 512, 3, 1, 1), (512, 512, 3, 1, 1), (512, 256, 3, 1, 1),
    (256, 128, 3, 1, 1), (128, 512, 1, 1, 0), (512, 38, 1, 1, 0),
    (512, 19, 1, 1, 0), (185, 128, 7, 1, 3), (128, 128, 7, 1, 3),
    (128, 128, 1, 1, 0), (128, 38, 1, 1, 0), (128, 19, 1, 1, 0),
]
SHAPES = sorted(set(ARCFACE_SHAPES) | set(OPENPOSE_SHAPES))


def conv_shapes(model):
    return {(m.weight_q.shape[1], m.weight_q.shape[0], m.weight_q.shape[2],
             m.stride, m.padding)
            for m in model.modules() if isinstance(m, quant.QuantConv2d)}


def jax_conv(x, weight_q, scale, stride, padding, dtype):
    """The JAX package's quant_conv, jitted as its models run it, on an
    NHWC array with the port's OIHW int8 weight."""
    qp = {"kernel_q": jnp.asarray(weight_q.numpy().transpose(2, 3, 1, 0)),
          "kernel_scale": jnp.asarray(scale.numpy())}
    fn = jax.jit(jax_quant.quant_conv, static_argnums=(2, 3, 4))
    return np.asarray(fn(jnp.asarray(x), qp, stride, padding, dtype)
                      .astype(jnp.float32))


def weights_and_input(shape, seed, hw=(9, 11), batch=2):
    cin, cout, kernel, _, _ = shape
    rng = np.random.default_rng(seed)
    w = rng.normal(scale=0.1, size=(cout, cin, kernel, kernel))
    x = rng.normal(size=(batch,) + hw + (cin,))
    return torch.from_numpy(w.astype(np.float32)), x.astype(np.float32)


def test_shapes_cover_both_models():
    assert conv_shapes(arcface.Int8FaceResNet100()) == set(ARCFACE_SHAPES)
    assert conv_shapes(openpose.Int8BodyPoseModel()) == set(OPENPOSE_SHAPES)


@pytest.fixture(scope="module")
def arcface_state():
    return random_arcface_state_dict(np.random.default_rng(7))


@pytest.fixture(scope="module")
def openpose_state():
    return random_openpose_state_dict(np.random.default_rng(5))


def assert_same_state(got, expected):
    assert got.keys() == expected.keys()
    for key, value in expected.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_arcface_weights_match_jax(arcface_state, dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = arcface.quantize_params(convert_arcface(arcface_state), tdt)
    tree = jax_arcface.quantize_params(jax_convert_arcface(arcface_state),
                                       jdt)
    carried = params_from_jax(tree)
    # params_from_jax widens float leaves to float32; the port keeps them
    # in the compute dtype, the 'embed' head in float32.
    assert_same_state({k: v.to(torch.float32) if v.is_floating_point()
                       else v for k, v in got.items()}, carried)
    assert got["embed.weight"].dtype == torch.float32
    assert got["initial.scale"].dtype == tdt
    assert got["stage0_unit0.prelu"].dtype == tdt
    assert got["initial.conv.weight_scale"].dtype == torch.float32
    assert tree["initial"]["scale"].dtype == jdt
    quantised = [k for k in got if k.endswith(".weight_q")]
    assert len(quantised) == 103  # 1 + 2 x 49 units + 4 shortcuts
    assert int(got["initial.conv.weight_q"].abs().max()) == 127


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_openpose_weights_match_jax(openpose_state, dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = openpose.quantize_params(convert_openpose(openpose_state), tdt)
    tree = jax_openpose.quantize_params(
        jax_convert_openpose(openpose_state), jdt)
    assert_same_state({k: v.to(torch.float32) if v.is_floating_point()
                       else v for k, v in got.items()},
                      params_from_jax(tree))
    # The biases ride along in the compute dtype (bf16 rounds them).
    assert got["conv1_1.bias"].dtype == tdt
    assert tree["conv1_1"]["conv"]["bias"].dtype == jdt
    assert len([k for k in got if k.endswith(".weight_q")]) == 92


def test_quantize_takes_float32_masters_only(openpose_state):
    state = convert_openpose(openpose_state)
    with pytest.raises(TypeError, match="float32"):
        quant.quantize_conv_weight(state["conv1_1.weight"].to(torch.bfloat16))
    # A quantised state dict passes through as it is.
    once = openpose.quantize_params(state, torch.bfloat16)
    assert_same_state(openpose.quantize_params(once, torch.bfloat16), once)


def test_int8_modules_load_their_state_dicts(arcface_state, openpose_state):
    for model, state in (
            (arcface.Int8FaceResNet100(torch.bfloat16),
             arcface.quantize_params(convert_arcface(arcface_state),
                                     torch.bfloat16)),
            (openpose.Int8BodyPoseModel(torch.bfloat16),
             openpose.quantize_params(convert_openpose(openpose_state),
                                      torch.bfloat16))):
        model.load_state_dict(state, strict=True)
        assert model.compute_dtype == torch.bfloat16
        # The product's matrices are derived from the loaded weights and
        # are not part of the state dict.
        assert "weight_mat" not in " ".join(model.state_dict())
        for module in model.modules():
            if isinstance(module, quant.QuantConv2d):
                assert torch.equal(module.weight_mat,
                                   quant.conv_weight_matrix(module.weight_q))
                assert module.weight_scale.dtype == torch.float32


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_quant_conv_matches_jax(shape):
    _, _, _, stride, padding = shape
    w, x = weights_and_input(shape, seed=sum(shape))
    weight_q, scale = quant.quantize_conv_weight(w)
    got = quant.quant_conv(torch.from_numpy(x), weight_q, scale, stride,
                           padding, torch.float32)
    np.testing.assert_array_equal(
        got.numpy(), jax_conv(x, weight_q, scale, stride, padding,
                              jnp.float32))
    # bf16 in and out, as the models run on the card.
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = quant.quant_conv(xb, weight_q, scale, stride, padding,
                           torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.to(torch.float32).numpy(),
        jax_conv(jnp.asarray(xb.to(torch.float32).numpy(), jnp.bfloat16),
                 weight_q, scale, stride, padding, jnp.bfloat16))


def test_accumulators_above_2_to_24_match_jax():
    """All activations and weights at 127: every accumulator of the 3x3
    conv over 512 channels is 127 * 127 * 4608 = 74,322,432 in the
    interior, above 2**24, where the float32 conversion rounds."""
    shape = (512, 512, 3, 1, 1)
    x = np.full((1, 5, 6, 512), 3.0, np.float32)
    w = torch.full((512, 512, 3, 3), 0.25)
    weight_q, scale = quant.quantize_conv_weight(w)
    xq, xs = quant.quantize_activation(torch.from_numpy(x))
    acc = quant.conv_int32_plain(xq, weight_q, 1, 1)
    assert int(acc.max()) == 127 * 127 * 4608 > 2 ** 24
    got = quant.quant_conv(torch.from_numpy(x), weight_q, scale, *shape[3:],
                           torch.float32)
    np.testing.assert_array_equal(
        got.numpy(), jax_conv(x, weight_q, scale, *shape[3:], jnp.float32))
    assert torch.equal(acc, quant.conv_int32_int_mm(
        xq, quant.conv_weight_matrix(weight_q), 512, 3, 1, 1))


def test_activation_scale_is_the_jitted_reciprocal_product():
    """A maximum where ``m * float32(1/127)`` and ``m / 127`` differ: the
    port's scale is the jitted JAX program's product."""
    m = np.float32(1.0)
    recip = np.float32(1.0 / 127.0)
    while np.float32(m * recip) == np.float32(m / np.float32(127.0)):
        m = np.nextafter(m, np.float32(2.0))
    x = np.zeros((1, 4, 4, 8), np.float32)
    x[0, 1, 2, 3] = m
    _, xs = quant.quantize_activation(torch.from_numpy(x))
    assert xs.item() == np.float32(m * recip) != np.float32(m / 127.0)
    jit_xs = jax.jit(lambda v: jnp.maximum(
        jnp.max(jnp.abs(v)).astype(jnp.float32) / 127.0, 1e-12))(x)
    assert xs.item() == float(jit_xs)
    w, _ = weights_and_input((8, 8, 3, 1, 1), seed=3)
    weight_q, scale = quant.quantize_conv_weight(w)
    np.testing.assert_array_equal(
        quant.quant_conv(torch.from_numpy(x), weight_q, scale, 1, 1,
                         torch.float32).numpy(),
        jax_conv(x, weight_q, scale, 1, 1, jnp.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int_mm_path_matches_plain(shape):
    """The eager im2col + torch._int_mm against the float64 conv, int32
    for int32, with post-ReLU (non-negative) activations as the models
    feed them; one output row only, padded to the 17 rows _int_mm needs
    on CUDA."""
    cout, kernel, stride, padding = shape[1:]
    w, x = weights_and_input(shape, seed=2 * sum(shape) + 1)
    weight_q, _ = quant.quantize_conv_weight(w)
    mat = quant.conv_weight_matrix(weight_q)
    assert mat.shape[0] % 8 == 0 and mat.shape[1] % 8 == 0
    assert mat.stride() == (1, mat.shape[0])  # column-major
    for inputs in (x, x[:1, :1, :1]):  # (2, 9, 11) and a single pixel
        xq, _ = quant.quantize_activation(torch.from_numpy(
            np.maximum(inputs, 0)))
        launches = quant.quant_conv.launches
        got = quant.conv_int32_int_mm(xq, mat, cout, kernel, stride, padding)
        assert quant.quant_conv.launches == launches + 1
        expected = quant.conv_int32_plain(xq, weight_q, stride, padding)
        assert got.dtype == torch.int32 and got.shape == expected.shape
        assert torch.equal(got, expected)


def test_im2col_pads_k_and_rows():
    xq = torch.arange(2 * 3 * 3 * 3, dtype=torch.float32).reshape(
        2, 3, 3, 3) % 127
    cols, (n, ho, wo) = quant.im2col_int8(xq, 3, 1, 1)
    assert (n, ho, wo) == (2, 3, 3)
    assert cols.shape == (18, 32) and cols.dtype == torch.int8
    assert not cols[:, 27:].any()
    # Row (0, 1, 1) is the whole 3x3 image 0 in (kh, kw, c) order.
    assert torch.equal(cols[4, :27], xq[0].reshape(-1).to(torch.int8))
    cols, (n, ho, wo) = quant.im2col_int8(xq[:1, :1, :1], 1, 1, 0)
    assert cols.shape == (17, 8) and not cols[1:].any()


def test_quant_conv_runs_on_cpu_and_cuda_only():
    w = torch.zeros((8, 8, 1, 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        quant.quant_conv(torch.zeros((1, 4, 4, 8), device="meta"), w,
                         torch.ones(8), 1, 0, torch.float32)
    launches = quant.quant_conv.launches
    quant.quant_conv(torch.ones((1, 4, 4, 8)), w, torch.ones(8), 1, 0,
                     torch.float32)
    assert quant.quant_conv.launches == launches  # the plain version
