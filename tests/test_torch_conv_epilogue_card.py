"""The conv epilogue kernel (``terran_tpu_torch/csrc/conv_epilogue.cu``)
against its plain version, on the card; skipped without one.

- Bit for bit (NaN where both are NaN, the sign of a zero kept), in every
  mode: the bias or the affine, no activation, a ReLU or a PReLU, with or
  without a residual; bf16 and float32; channels-last and contiguous
  NCHW; at the pipeline's channel counts (8-512), BODY_25's 96, the odd
  19, 26, 38 and 52 and a 3; on fields whose H * W is and is not a
  multiple of the 16-byte vector; with NaN, +-inf and -0 among the
  inputs; out of place and in place; on a misaligned view.
- Its error against float64 no larger than the eager bf16 chain's.
- Inside a CUDA graph's capture and replay.
- Refusing, on a CUDA tensor, a layout, dtype or operand it does not take.
- RetinaFace, FaceResNet100, OpenPose and BODY_25 in bf16: every conv and
  FaceResNet100's two standalone affines a unit go through it, counted by
  mode where it launches, and each model equals itself with the plain
  version in its place, bit for bit; the int8 trunks launch it never.

This file imports no JAX, which the card's machine lacks, and needs no
conftest: run it there with ``python -m pytest
tests/test_torch_conv_epilogue_card.py -m card --noconftest -q``.
"""

import collections

import numpy as np
import pytest
import torch
from torch import nn

from terran_tpu_torch.models import arcface, layers, load_model
from terran_tpu_torch.ops import conv_epilogue as ce
from terran_tpu_torch.utils.convert import (
    convert_arcface, convert_body25, convert_openpose, convert_retinaface,
)
from torch_body25_weights import body25_state_dict
from torch_oracle import (
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict,
)

pytestmark = pytest.mark.card

DTYPES = ["bfloat16", "float32"]
LAYOUTS = ["channels_last", "nchw"]
MODES = [(affine, act, residual) for affine in (False, True)
         for act in ("none", "relu", "prelu") for residual in (False, True)]
MODE_IDS = [f"{'affine' if a else 'bias'}-{act}{'-residual' if r else ''}"
            for a, act, r in MODES]
# (channels, height, width): the pipeline's channel counts on its fields
# (H * W a multiple of 8 or not), BODY_25's 96 and 52/26 on its 46 x 81,
# OpenPose's 38 and 19 on 23 x 41, and a ragged 3 x 5 x 7.
SHAPES = [(8, 26, 47), (16, 52, 93), (32, 104, 185), (64, 56, 56),
          (96, 46, 81), (128, 23, 40), (256, 14, 14), (512, 7, 7),
          (19, 23, 41), (26, 46, 81), (38, 23, 41), (52, 46, 81), (3, 5, 7)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def inputs(gen, shape, dtype, layout, dev, specials=True):
    """x, a residual, and per-channel scale, bias and PReLU slopes, in
    ``dtype`` on ``dev``; with ``specials``, NaN, +-inf and +-0 in x, a
    -0 bias, a zero scale and a zero slope."""
    c = shape[1]
    x = torch.randn(shape, generator=gen, device=dev) * 4
    if specials:
        flat = x.view(-1)
        flat[:6] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                 -0.0, 0.0, float("nan")], device=dev)
        flat[torch.randint(0, flat.numel(), (flat.numel() // 50,),
                           generator=gen, device=dev)] = -0.0
    residual = torch.randn(shape, generator=gen, device=dev)
    scale = torch.rand(c, generator=gen, device=dev) + 0.5
    bias = torch.randn(c, generator=gen, device=dev)
    alpha = torch.randn(c, generator=gen, device=dev) * 0.3
    if specials:
        bias[0], scale[min(1, c - 1)], alpha[0] = -0.0, 0.0, 0.0
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    x, residual = (t.to(dtype).contiguous(memory_format=fmt)
                   for t in (x, residual))
    return x, residual, scale.to(dtype), bias.to(dtype), alpha.to(dtype)


def kwargs(mode, residual, scale, bias, alpha):
    affine, act, with_residual = mode
    return {"bias": bias, "scale": scale if affine else None,
            "relu": act == "relu", "alpha": alpha if act == "prelu" else None,
            "residual": residual if with_residual else None}


def assert_bits_equal(got, expected, label):
    """Equal dtype, shape, strides, NaN positions and bits elsewhere."""
    assert (got.dtype, got.shape, got.stride()) == (
        expected.dtype, expected.shape, expected.stride()), label
    nan = got.isnan()
    assert torch.equal(nan, expected.isnan()), f"{label}: NaNs differ"
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    a = torch.where(nan, 0, got).flatten().view(bits[got.dtype])
    b = torch.where(nan, 0, expected).flatten().view(bits[got.dtype])
    assert torch.equal(a, b), f"{label}: the kernel and plain differ"


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_the_kernel_equals_its_plain_version(card, mode, dtype, layout):
    gen = torch.Generator(device=card).manual_seed(17)
    for c, h, w in SHAPES:
        x, residual, scale, bias, alpha = inputs(
            gen, (2, c, h, w), getattr(torch, dtype), layout, card)
        kw = kwargs(mode, residual, scale, bias, alpha)
        want = ce.conv_epilogue_plain(x, **kw)
        label = f"{MODE_IDS[MODES.index(mode)]} {dtype} {layout} {c}x{h}x{w}"
        before = x.clone()
        assert_bits_equal(ce.conv_epilogue(x, **kw), want, label)
        assert_bits_equal(x, before, f"{label}: x written out of place")
        got = ce.conv_epilogue(x, inplace=True, **kw)
        assert got.data_ptr() == x.data_ptr()
        assert_bits_equal(got, want, f"{label} in place")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_misaligned_view_takes_the_scalar_path(card, dtype):
    """x one element into its storage (2 or 4 bytes off 16): the kernel
    reads it element by element and still equals the plain version."""
    gen = torch.Generator(device=card).manual_seed(5)
    dt = getattr(torch, dtype)
    shape = (2, 64, 14, 14)
    buf = torch.randn(int(np.prod(shape)) + 1, generator=gen,
                      device=card).to(dt)
    x = buf[1:].view(2, 14, 14, 64).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16 != 0
    _, residual, scale, bias, alpha = inputs(gen, shape, dt, "channels_last",
                                             card)
    for mode in MODES:
        kw = kwargs(mode, residual, scale, bias, alpha)
        assert_bits_equal(ce.conv_epilogue(x, **kw),
                          ce.conv_epilogue_plain(x, **kw), f"{mode}")


def eager_chain(x, bias=None, scale=None, relu=False, alpha=None,
                residual=None):
    """The ops the models ran before the epilogue, each in x's dtype."""
    def ch(v):
        return v.reshape(1, -1, 1, 1)

    if scale is not None:
        x = x * ch(scale)
    if bias is not None:
        x = x + ch(bias)
    if relu:
        x = torch.relu(x)
    elif alpha is not None:
        x = torch.where(x >= 0, x, x * ch(alpha))
    if residual is not None:
        x = x + residual
    return x


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_bf16_error_no_larger_than_the_eager_chains(card, mode):
    """Against float64 ops on the same bf16 inputs, the kernel's largest
    and mean errors are no larger than the eager bf16 chain's."""
    gen = torch.Generator(device=card).manual_seed(23)
    x, residual, scale, bias, alpha = inputs(
        gen, (8, 128, 23, 40), torch.bfloat16, "channels_last", card,
        specials=False)
    kw = kwargs(mode, residual, scale, bias, alpha)
    ref = eager_chain(x.double(), **{
        k: v.double() if isinstance(v, torch.Tensor) else v
        for k, v in kw.items()})
    err = (ce.conv_epilogue(x, **kw).double() - ref).abs()
    eager = (eager_chain(x, **kw).double() - ref).abs()
    assert float(err.max()) <= float(eager.max())
    assert float(err.mean()) <= float(eager.mean())


def test_the_kernel_under_a_cuda_graph(card):
    gen = torch.Generator(device=card).manual_seed(29)
    x, residual, scale, bias, alpha = inputs(
        gen, (8, 64, 56, 56), torch.bfloat16, "channels_last", card,
        specials=False)
    src = x.clone()
    kw = {"bias": bias, "scale": scale, "alpha": alpha, "residual": residual}
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ce.conv_epilogue(x, inplace=True, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    launches = sum(ce.conv_epilogue.launches.values())
    with torch.cuda.graph(graph):
        ce.conv_epilogue(x, inplace=True, **kw)
    assert sum(ce.conv_epilogue.launches.values()) == launches + 1
    for _ in range(2):
        x.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert_bits_equal(x, ce.conv_epilogue_plain(src, **kw), "replay")


def test_cuda_tensors_the_kernel_does_not_take_raise(card):
    x = torch.zeros((2, 16, 4, 6), dtype=torch.bfloat16, device=card)
    v = torch.zeros(16, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="no conv epilogue kernel"):
        ce.conv_epilogue(x.transpose(2, 3), bias=v)
    with pytest.raises(ValueError, match="no conv epilogue kernel"):
        ce.conv_epilogue(x[:, :, 1:], bias=v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ce.conv_epilogue(x.half(), bias=v.half())
    with pytest.raises(ValueError, match="residual"):
        ce.conv_epilogue(x.contiguous(memory_format=torch.channels_last),
                         bias=v, residual=x)
    with pytest.raises(ValueError, match="per-channel"):
        ce.conv_epilogue(x, bias=v.float())


def conv_count(model):
    """The floating-point convs and standalone affines of ``model``: the
    epilogues one forward launches."""
    return sum(isinstance(m, (nn.Conv2d, layers.Affine))
               for m in model.modules())


def bf16_models(card):
    rng = np.random.default_rng(31)
    params = {
        "retinaface": convert_retinaface(random_retinaface_state_dict(rng)),
        "arcface": convert_arcface(random_arcface_state_dict(rng)),
        "openpose": convert_openpose(random_openpose_state_dict(rng)),
        "body25": convert_body25(body25_state_dict(rng)),
    }
    gen = torch.Generator(device=card).manual_seed(37)
    inputs = {
        "retinaface": torch.randint(0, 256, (2, 96, 128, 3), generator=gen,
                                    device=card).float(),
        "arcface": torch.randint(0, 256, (4, 112, 112, 3), generator=gen,
                                 device=card).float(),
        "openpose": torch.rand((2, 46, 82, 3), generator=gen,
                               device=card) - 0.5,
        "body25": torch.rand((2, 48, 80, 3), generator=gen,
                             device=card) - 0.5,
    }
    for family, p in params.items():
        model = load_model(family, p, torch.bfloat16, card)
        yield family, model, inputs[family].to(
            model.compute_dtype if family != "arcface" else torch.float32)


def test_every_bf16_conv_takes_the_kernel(card, monkeypatch):
    torch.backends.cudnn.deterministic = True
    for family, model, x in bf16_models(card):
        def run():
            with torch.inference_mode():
                out = model(x)
            return out if isinstance(out, (tuple, list)) else (
                tuple(t for v in out.values() for t in v)
                if isinstance(out, dict) else (out,))

        before = collections.Counter(ce.conv_epilogue.launches)
        got = run()
        launched = ce.conv_epilogue.launches - before
        assert sum(launched.values()) == conv_count(model), (
            family, dict(launched))
        with monkeypatch.context() as patch:
            patch.setattr(ce, "conv_epilogue_kernel",
                          lambda x, bias, scale, relu, alpha, residual,
                          inplace: ce.conv_epilogue_plain(
                              x, bias, scale, relu, alpha, residual))
            want = run()
        for i, (a, b) in enumerate(zip(got, want)):
            assert_bits_equal(a, b, f"{family} output {i}")


def test_int8_trunks_launch_no_epilogue(card):
    rng = np.random.default_rng(41)
    model = load_model("arcface", convert_arcface(
        random_arcface_state_dict(rng)), torch.bfloat16, card,
        precision="int8")
    assert isinstance(model, arcface.Int8FaceResNet100)
    before = collections.Counter(ce.conv_epilogue.launches)
    with torch.inference_mode():
        model(torch.zeros((2, 112, 112, 3), device=card))
    assert ce.conv_epilogue.launches == before
