"""The int8 conv's kernels (``terran_tpu_torch/csrc/quant_conv.cu``)
against the eager passes they replace, on the card; skipped without one.

Every comparison is exact (``torch.equal``; NaN where both are NaN):
``max|x|``, the activation scale, every byte of the column matrix (the
spatial, K and row padding included), the int32 products and each
epilogue mode's output, for every distinct conv shape of both int8 trunks
(``test_torch_quant.py::test_shapes_cover_both_models`` holds the shapes
to the modules), in bf16 and float32, and for an all-zero activation
(the 1e-12 floor), a NaN, a misaligned activation and accumulators above
2**24. Whole convs and both int8 models take the kernels for every conv,
each kernel counted once a conv where it launches, and equal the plain
float64 convs with the eager epilogues on the card.

This file imports no JAX, which the card's machine lacks, and needs no
conftest: run it there with ``python -m pytest
tests/test_torch_quant_kernels.py -m card --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from terran_tpu_torch.models import arcface, openpose, quant
from terran_tpu_torch.utils.convert import convert_arcface, convert_openpose
from torch_oracle import random_arcface_state_dict, random_openpose_state_dict

DTYPES = ["bfloat16", "float32"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def shapes():
    """Every distinct (cin, cout, kernel, stride, padding) of both int8
    trunks, from their modules."""
    return sorted({(m.weight_q.shape[1], m.weight_q.shape[0],
                    m.weight_q.shape[2], m.stride, m.padding)
                   for model in (arcface.Int8FaceResNet100(),
                                 openpose.Int8BodyPoseModel())
                   for m in model.modules()
                   if isinstance(m, quant.QuantConv2d)})


def assert_same(got, expected, label):
    assert (got.dtype, got.shape) == (expected.dtype, expected.shape), label
    if got.is_floating_point():
        same = (torch.equal(got.isnan(), expected.isnan())
                and torch.equal(got.nan_to_num(), expected.nan_to_num()))
    else:
        same = torch.equal(got, expected)
    assert same, f"{label}: the kernel and the eager passes differ"


def conv_weights(shape, gen, dev):
    cin, cout, kernel, _, _ = shape
    w = torch.randn((cout, cin, kernel, kernel), generator=gen,
                    device=dev) / (cin * kernel * kernel) ** 0.5
    weight_q, scale = quant.quantize_conv_weight(w)
    return weight_q, scale, quant.conv_weight_matrix(weight_q)


def epilogues(cout, dtype, gen, dev):
    """(name, kwargs) of each epilogue mode, with float64 copies of
    parameters drawn in the compute dtype, as the modules keep them."""
    bias64 = torch.randn(cout, generator=gen, device=dev).to(dtype).to(
        torch.float64)
    scale64 = (torch.rand(cout, generator=gen, device=dev) + 0.5).to(
        dtype).to(torch.float64)
    return [("dequantize", {}),
            ("bias", {"bias64": bias64}),
            ("bias+relu", {"bias64": bias64, "relu": True}),
            ("affine", {"bias64": bias64, "scale64": scale64})]


KERNELS = quant.QUANTIZE_KERNELS + (quant.EPILOGUE_KERNEL,)


def launch_counts(since=None):
    """Each kernel's launches and the ``_int_mm`` calls so far, less
    ``since``."""
    counts = {name: quant.quant_conv.fused[name] for name in KERNELS}
    counts["int_mm"] = quant.quant_conv.launches
    if since is not None:
        counts = {name: n - since[name] for name, n in counts.items()}
    return counts


def expected_counts(convs):
    return dict.fromkeys(KERNELS + ("int_mm",), convs)


def check_conv(x, shape, gen, label):
    """The kernels' quantisation, product and every epilogue mode of one
    conv of ``x`` against the eager passes and the float64 conv."""
    _, cout, kernel, stride, padding = shape
    weight_q, scale, weight_mat = conv_weights(shape, gen, x.device)
    cols, scalars, (n, ho, wo) = quant.quantize_im2col(
        x, kernel, stride, padding)
    xq, xs_eager = quant.quantize_activation(x)
    cols_eager, dims = quant.im2col_int8(xq, kernel, stride, padding)
    assert dims == (n, ho, wo), label
    max_abs, xs = scalars
    assert_same(max_abs, x.abs().amax().to(torch.float32), f"{label} max|x|")
    assert_same(xs, xs_eager, f"{label} xs")
    assert_same(cols, cols_eager, f"{label} column matrix")
    m = n * ho * wo
    acc = torch._int_mm(cols, weight_mat)
    acc_nhwc = acc[:m, :cout].reshape(n, ho, wo, cout)
    assert_same(acc_nhwc, quant.conv_int32_int_mm(
        xq, weight_mat, cout, kernel, stride, padding),
        f"{label} int32 product")
    if not xs.isnan():  # a NaN has no integer in the float64 conv
        assert_same(acc_nhwc, quant.conv_int32_plain(xq, weight_q, stride,
                                                     padding),
                    f"{label} int32 product against the float64 conv")
    for name, kwargs in epilogues(cout, x.dtype, gen, x.device):
        got = quant.dequant_epilogue(acc, scalars, (n, ho, wo), cout, scale,
                                     x.dtype, **kwargs)
        expected = quant.epilogue_plain(acc_nhwc, xs_eager, scale, x.dtype,
                                        **kwargs)
        assert_same(got, expected, f"{label} {name} epilogue")
        before = launch_counts()
        got = quant.quant_conv(x, weight_q, scale, stride, padding, x.dtype,
                               weight_mat, **kwargs)
        assert launch_counts(since=before) == expected_counts(1), label
        assert_same(got, quant.quant_conv_plain(
            x, weight_q, scale, stride, padding, x.dtype, **kwargs),
            f"{label} {name} quant_conv against the float64 conv")


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_equal_the_eager_passes(card, shapes, dtype):
    """Every conv shape of both trunks on a (2, 9, 11) input and on one
    pixel (one output row: the 16 padding rows of _int_mm's 17)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(11)
    for shape in shapes:
        for hw, batch in (((9, 11), 2), ((1, 1), 1)):
            x = torch.randn((batch,) + hw + (shape[0],), generator=gen,
                            device=card).to(dt)
            check_conv(x, shape, gen, f"{dtype} {shape} on {tuple(x.shape)}")
    torch.cuda.synchronize()


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_on_edge_activations(card, dtype):
    """An all-zero activation (xs is the 1e-12 floor), a NaN (NaN scale
    and outputs, as the eager passes give), an activation one element off
    a 16-byte boundary (the scalar paths), and accumulators above
    2**24."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=card).manual_seed(12)
    for shape in ((64, 64, 3, 1, 1), (3, 64, 3, 1, 1), (185, 128, 7, 1, 3),
                  (512, 38, 1, 1, 0)):
        cin = shape[0]
        zeros = torch.zeros((2, 9, 11, cin), dtype=dt, device=card)
        check_conv(zeros, shape, gen, f"{dtype} {shape} zeros")
        _, (_, xs), _ = quant.quantize_im2col(zeros, *shape[2:])
        assert xs.item() == np.float32(quant.SCALE_FLOOR)
        nan = torch.randn((2, 9, 11, cin), generator=gen, device=card).to(dt)
        nan[1, 4, 5, cin - 1] = float("nan")
        check_conv(nan, shape, gen, f"{dtype} {shape} NaN")
        _, (_, xs), _ = quant.quantize_im2col(nan, *shape[2:])
        assert xs.isnan()
        flat = torch.randn(2 * 9 * 11 * cin + 1, generator=gen,
                           device=card).to(dt)
        off = flat[1:].view(2, 9, 11, cin)
        assert off.data_ptr() % 16 != 0
        check_conv(off, shape, gen, f"{dtype} {shape} misaligned")
    # Half-integer quotients and their float32 neighbours: the kernel's
    # product by 1 / xs rounds otherwise there, and it divides instead.
    max_abs = torch.tensor(127 * 0.37, device=card)
    xs = torch.clamp(max_abs * quant.QMAX_RECIPROCAL, min=quant.SCALE_FLOOR)
    ties = (torch.arange(-127, 127, device=card) + 0.5) * xs
    inf = torch.full_like(ties, float("inf"))
    up = down = ties
    near = [ties]
    for _ in range(3):
        up, down = torch.nextafter(up, inf), torch.nextafter(down, -inf)
        near += [up, down]
    values = torch.cat(near + [max_abs[None]])
    values = torch.cat([values, values.new_zeros(-len(values) % 48)])
    for cin in (16, 3):
        x = values.reshape(1, 1, -1, cin).to(dt)
        check_conv(x, (cin, 8, 1, 1, 0), gen, f"{dtype} half-integer ties")
    x = torch.full((1, 5, 6, 512), 3.0, dtype=dt, device=card)
    weight_q, scale = quant.quantize_conv_weight(
        torch.full((512, 512, 3, 3), 0.25, device=card))
    cols, _, _ = quant.quantize_im2col(x, 3, 1, 1)
    acc = torch._int_mm(cols, quant.conv_weight_matrix(weight_q))
    assert int(acc.max()) == 127 * 127 * 4608 > 2 ** 24
    assert_same(quant.quant_conv(x, weight_q, scale, 1, 1, dt),
                quant.quant_conv_plain(x, weight_q, scale, 1, 1, dt),
                f"{dtype} accumulators above 2**24")
    torch.cuda.synchronize()


def test_epilogue_mode_follows_the_arguments():
    ones = torch.ones(4, dtype=torch.float64)
    assert quant.epilogue_mode(None, None, False) == quant.DEQUANTIZE
    assert quant.epilogue_mode(ones, None, True) == quant.BIAS
    assert quant.epilogue_mode(ones, ones, False) == quant.AFFINE
    for bias64, scale64, relu in ((None, None, True), (ones, ones, True),
                                  (None, ones, False)):
        with pytest.raises(ValueError):
            quant.epilogue_mode(bias64, scale64, relu)


def test_kernels_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="no quant_conv kernel"):
        quant.quantize_im2col(torch.ones((1, 4, 4, 8)), 3, 1, 1)
    with pytest.raises(ValueError, match="no output"):
        quant.conv_dims(torch.ones((1, 2, 2, 8)), 7, 1, 0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_models_take_the_kernels(card, dtype, monkeypatch):
    """Both int8 trunks, every conv through the kernels (103 + 92, each
    kernel counted once a conv), equal to the same trunks through the
    plain float64 convs and eager epilogues on the card."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    rec = arcface.Int8FaceResNet100(dt)
    rec.load_state_dict(arcface.quantize_params(
        convert_arcface(random_arcface_state_dict(rng)), dt))
    pose = openpose.Int8BodyPoseModel(dt)
    pose.load_state_dict(openpose.quantize_params(
        convert_openpose(random_openpose_state_dict(rng)), dt))
    rec, pose = rec.to(card).eval(), pose.to(card).eval()
    gen = torch.Generator(device=card).manual_seed(13)
    crops = torch.randint(0, 256, (4, 112, 112, 3), generator=gen,
                          device=card).to(torch.float32)
    frames = torch.rand((2, 46, 82, 3), generator=gen, device=card) - 0.5

    def run():
        with torch.inference_mode():
            return (rec(crops),) + tuple(pose(frames))

    before = launch_counts()
    got = run()
    assert launch_counts(since=before) == expected_counts(103 + 92)
    with monkeypatch.context() as patch:
        patch.setattr(quant, "quant_conv_kernels", quant.quant_conv_plain)
        before = launch_counts()
        expected = run()
    assert launch_counts(since=before) == expected_counts(0)
    for name, a, b in zip(("features", "pafs", "heatmaps"), got, expected):
        assert_same(a, b, f"{dtype} {name}")
