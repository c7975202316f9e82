"""The conv epilogue's plain version (``ops/conv_epilogue.py``) on the CPU.

- In float32 it is the eager chain it replaces, op for op: the affine or
  bias, the ReLU or the JAX models' PReLU, the residual add, with NaN,
  +-inf and -0 among the inputs, channels-last and contiguous NCHW.
- In bf16 it rounds once where the eager chain rounded after each op, so
  its error against float64 is no larger than the chain's.
- The modules that take it (``ConvBias``, ``ConvAffine``, ``Affine``,
  FaceResNet100's ``Unit``, BODY_25's convs, RetinaFace's heads) equal
  their eager forms in float32.
- The kernel's wrapper refuses, before any launch, what the kernel does
  not take; a CPU call launches nothing.

The kernel itself is held to this plain version on the card
(``tests/test_torch_conv_epilogue_card.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from terran_tpu_torch.models import arcface, body25, layers, retinaface
from terran_tpu_torch.ops import conv_epilogue as ce

# (scale, act, residual): every mode the kernel has.
MODES = [(affine, act, residual) for affine in (False, True)
         for act in ("none", "relu", "prelu") for residual in (False, True)]
MODE_IDS = [f"{'affine' if a else 'bias'}-{act}{'-residual' if r else ''}"
            for a, act, r in MODES]
LAYOUTS = ["channels_last", "nchw"]


def inputs(gen, shape, dtype, layout, specials=True):
    """x, a residual and per-channel scale, bias and PReLU slopes in
    ``dtype``; with ``specials``, NaN, +-inf and +-0 among x's values and
    a -0 bias, a zero scale and a zero and a negative slope."""
    n, c, h, w = shape
    x = torch.randn(shape, generator=gen) * 4
    if specials:
        flat = x.view(-1)
        flat[:6] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                 -0.0, 0.0, float("nan")])
        flat[torch.randint(0, flat.numel(), (flat.numel() // 50,),
                           generator=gen)] = -0.0
    residual = torch.randn(shape, generator=gen)
    scale = torch.rand(c, generator=gen) + 0.5
    bias = torch.randn(c, generator=gen)
    alpha = torch.randn(c, generator=gen) * 0.3
    if specials:
        bias[0], scale[min(1, c - 1)], alpha[0] = -0.0, 0.0, 0.0
    memory_format = (torch.channels_last if layout == "channels_last"
                     else torch.contiguous_format)
    x, residual = (t.to(dtype).contiguous(memory_format=memory_format)
                   for t in (x, residual))
    return x, residual, scale.to(dtype), bias.to(dtype), alpha.to(dtype)


def kwargs(mode, residual, scale, bias, alpha):
    affine, act, with_residual = mode
    return {"bias": bias, "scale": scale if affine else None,
            "relu": act == "relu", "alpha": alpha if act == "prelu" else None,
            "residual": residual if with_residual else None}


def eager_chain(x, bias=None, scale=None, relu=False, alpha=None,
                residual=None):
    """The ops the models ran before the epilogue, each in ``x``'s dtype:
    ``x * scale + bias``, ``torch.relu`` or ``where(x >= 0, x, x *
    alpha)``, ``+ residual``."""
    def ch(v):
        return v.to(x.dtype).reshape(1, -1, 1, 1)

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


def float64_chain(x, **kw):
    """The same ops in float64 on the same (rounded) inputs."""
    return eager_chain(x.to(torch.float64), **{
        k: (v.to(torch.float64) if isinstance(v, torch.Tensor) else v)
        for k, v in kw.items()})


def assert_bits_equal(got, expected, label):
    """Equal dtype, shape, strides, NaN positions and bits elsewhere
    (the sign of a zero included)."""
    assert (got.dtype, got.shape, got.stride()) == (
        expected.dtype, expected.shape, expected.stride()), label
    nan = got.isnan()
    assert torch.equal(nan, expected.isnan()), f"{label}: NaNs differ"
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    a = torch.where(nan, 0, got).flatten().view(bits[got.dtype])
    b = torch.where(nan, 0, expected).flatten().view(bits[got.dtype])
    assert torch.equal(a, b), f"{label}: values differ"


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_plain_is_the_eager_chain_in_float32(mode, layout):
    gen = torch.Generator().manual_seed(7)
    x, residual, scale, bias, alpha = inputs(gen, (2, 24, 5, 7),
                                             torch.float32, layout)
    kw = kwargs(mode, residual, scale, bias, alpha)
    assert_bits_equal(ce.conv_epilogue_plain(x, **kw), eager_chain(x, **kw),
                      f"{mode} {layout}")


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_plain_rounds_once_in_bf16(mode):
    """Against the float64 ops on the same bf16 inputs, the plain
    version's largest and mean errors are no larger than the eager bf16
    chain's."""
    gen = torch.Generator().manual_seed(11)
    x, residual, scale, bias, alpha = inputs(gen, (4, 32, 9, 11),
                                             torch.bfloat16, "channels_last",
                                             specials=False)
    kw = kwargs(mode, residual, scale, bias, alpha)
    ref = float64_chain(x, **kw)
    plain = (ce.conv_epilogue_plain(x, **kw).to(torch.float64) - ref).abs()
    eager = (eager_chain(x, **kw).to(torch.float64) - ref).abs()
    assert float(plain.max()) <= float(eager.max())
    assert float(plain.mean()) <= float(eager.mean())
    # One rounding: within half a bf16 ulp of the float64 value.
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert bool((plain <= 0.5 * ulp * (1 + 2 ** -15)).all())


def test_mode_names():
    v = torch.ones(3)
    assert ce.mode(bias=v) == "bias"
    assert ce.mode(bias=v, relu=True) == "bias+relu"
    assert ce.mode(bias=v, scale=v, alpha=v, residual=v) == (
        "affine+prelu+residual")
    assert ce.mode() == "none"
    with pytest.raises(ValueError, match="ReLU or a PReLU"):
        ce.mode(bias=v, relu=True, alpha=v)


def test_cpu_calls_launch_nothing():
    x = torch.randn(1, 4, 3, 3)
    before = dict(ce.conv_epilogue.launches)
    out = ce.conv_epilogue(x, bias=torch.ones(4), relu=True, inplace=True)
    assert dict(ce.conv_epilogue.launches) == before
    assert torch.equal(out, torch.relu(x + 1))


def _meta(shape=(2, 16, 4, 6), dtype=torch.bfloat16, layout="channels_last"):
    x = torch.empty(shape, dtype=dtype, device="meta")
    return (x.contiguous(memory_format=torch.channels_last)
            if layout == "channels_last" else x)


REFUSED = {
    "transposed": (lambda: (_meta().transpose(2, 3), {}), ValueError),
    "sliced": (lambda: (_meta(layout="nchw")[:, :, 1:], {}), ValueError),
    "3-d": (lambda: (torch.empty((2, 16, 4), dtype=torch.bfloat16,
                                 device="meta"), {}), ValueError),
    "float16": (lambda: (_meta(dtype=torch.float16), {}), TypeError),
    "float64": (lambda: (_meta(dtype=torch.float64), {}), TypeError),
    "residual in another layout": (lambda: (_meta(), {
        "residual": _meta(layout="nchw")}), ValueError),
    "residual in another dtype": (lambda: (_meta(), {
        "residual": _meta(dtype=torch.float32)}), ValueError),
    "bias in another dtype": (lambda: (_meta(), {
        "bias": torch.empty(16, device="meta")}), ValueError),
    "bias of another length": (lambda: (_meta(), {
        "bias": torch.empty(8, dtype=torch.bfloat16, device="meta")}),
        ValueError),
    "relu and prelu": (lambda: (_meta(), {
        "relu": True,
        "alpha": torch.empty(16, dtype=torch.bfloat16, device="meta")}),
        ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_kernel_path_refuses_what_it_does_not_take(case):
    """The CUDA path's checks, which run before any launch, on tensors
    with no storage."""
    make, error = REFUSED[case]
    x, kw = make()
    with pytest.raises(error):
        ce.conv_epilogue_kernel(x, **kw)


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no conv epilogue on meta"):
        ce.conv_epilogue(_meta(), bias=torch.empty(16, device="meta"))


def _conv_affine(act):
    """A ConvAffine and the keywords of its call: with act 'prelu' an
    'none' module called with the caller's slopes, as FaceResNet100's
    units call theirs."""
    m = layers.ConvAffine(6, 16, 3, 1, 1,
                          act="none" if act == "prelu" else act)
    with torch.no_grad():
        m.scale.uniform_(0.5, 1.5)
        m.bias.normal_()
    kw = {}
    if act == "prelu":
        kw["alpha"] = torch.empty(16).uniform_(-0.5, 0.5)
    return m, kw


def _eager_conv_affine(m, x, alpha=None):
    return eager_chain(m.conv(x), bias=m.bias, scale=m.scale,
                       relu=m.act == "relu", alpha=alpha)


def _unit(shortcut):
    torch.manual_seed(3)
    m = arcface.Unit(16, 32 if shortcut else 16, 2 if shortcut else 1,
                     has_shortcut=shortcut)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 1:
                p.uniform_(-0.5, 1.5)
    return m


def _eager_unit(m, x):
    body = eager_chain(x, bias=m.pre.bias, scale=m.pre.scale)
    body = eager_chain(m.conv1.conv(body), bias=m.conv1.bias,
                       scale=m.conv1.scale, alpha=m.prelu)
    body = eager_chain(m.conv2.conv(body), bias=m.conv2.bias,
                       scale=m.conv2.scale)
    short = (x if m.shortcut is None else eager_chain(
        m.shortcut.conv(x), bias=m.shortcut.bias, scale=m.shortcut.scale))
    return body + short


def _affine():
    m = layers.Affine(6)
    with torch.no_grad():
        m.scale.uniform_(0.5, 1.5)
        m.bias.normal_()
    return m


MODULES = {
    "ConvAffine relu": (lambda: _conv_affine("relu"), _eager_conv_affine, 6),
    "ConvAffine prelu": (lambda: _conv_affine("prelu"), _eager_conv_affine,
                         6),
    "ConvAffine none": (lambda: _conv_affine("none"), _eager_conv_affine, 6),
    "ConvBias relu": (lambda: layers.ConvBias(6, 16, 3, padding=1,
                                              act="relu"),
                      lambda m, x: torch.relu(F.conv2d(
                          x, m.weight, m.bias, padding=1)), 6),
    "ConvBias none": (lambda: layers.ConvBias(6, 16, 1, act="none"),
                      lambda m, x: F.conv2d(x, m.weight, m.bias), 6),
    "Affine": (_affine, lambda m, x: eager_chain(x, bias=m.bias,
                                                 scale=m.scale), 6),
    "Unit": (lambda: _unit(False), _eager_unit, 16),
    "Unit with shortcut": (lambda: _unit(True), _eager_unit, 16),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_modules_equal_their_eager_chains_in_float32(name):
    """Each module against the ops it ran before its epilogue was one
    pass, within float32 rounding (a conv with its bias inside may sum in
    another order than the conv and the bias apart)."""
    make, eager, cin = MODULES[name]
    torch.manual_seed(5)
    made = make()
    m, kw = made if isinstance(made, tuple) else (made, {})
    m.eval()
    x = torch.randn(2, cin, 9, 13).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got, want = m(x, **kw), eager(m, x, **kw)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_body25_convs_equal_their_eager_chains_in_float32():
    """BODY_25's ReLU, PReLU and linear convs against ``nn.Conv2d`` with
    its bias, then ``torch.relu`` or the ``nn.PReLU`` module."""
    torch.manual_seed(9)
    model = body25.Body25Model((8,) * 12, ((8, 16),) * 6).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0, 0.3)
        for name, act in (("conv1_1", "relu"), ("conv4_2", "prelu4_2"),
                          ("Mconv7_stage0_L2", None)):
            conv = getattr(model, name)
            x = torch.randn(1, conv.in_channels, 10, 12)
            want = conv(x)
            if act == "relu":
                want = torch.relu(want)
            elif act is not None:
                want = getattr(model, act)(want)
            torch.testing.assert_close(model._conv(name, x), want,
                                       rtol=1e-6, atol=1e-6)


def test_retinaface_heads_equal_their_biased_convs_in_float32():
    torch.manual_seed(4)
    heads = retinaface.Heads().eval()
    feats = [torch.randn(1, 64, s, s) for s in (8, 4, 2)]
    with torch.no_grad():
        got = heads(feats)
        for stride, feat in zip((8, 16, 32), feats):
            for head, out in zip(("cls", "bbox", "landmark"), got[stride]):
                want = getattr(heads, f"{head}_s{stride}")(feat)
                torch.testing.assert_close(out, want.permute(0, 2, 3, 1),
                                           rtol=1e-6, atol=1e-6)


def test_plain_keeps_the_layout():
    gen = torch.Generator().manual_seed(2)
    for layout in LAYOUTS:
        x, residual, scale, bias, alpha = inputs(gen, (2, 8, 3, 5),
                                                 torch.bfloat16, layout)
        out = ce.conv_epilogue_plain(x, bias=bias, scale=scale,
                                     residual=residual)
        assert out.stride() == x.stride()
        assert ce.channel_run(out) == (1 if layout == "channels_last"
                                       else 15)


def test_channel_run_of_an_ambiguous_layout():
    """At H = W = 1 a tensor is both channels-last and contiguous NCHW,
    and both read its channels alike."""
    x = torch.empty(2, 8, 1, 1)
    assert x.is_contiguous() and x.is_contiguous(
        memory_format=torch.channels_last)
    assert ce.channel_run(x) == 1
