"""Int8 post-training quantisation for the opt-in trunks.

The port of ``terran_tpu/models/quant.py``: symmetric static weight
scales, one per output channel (:func:`quantize_conv_weight`), and a
symmetric dynamic scale for the whole activation tensor, ``max|x| / 127``
(:func:`quant_conv`). The int8 x int8 -> int32 products are exact; the
two scales fold into one float32 multiply on the way out, in the JAX
operation order ``acc * (xs * scale)``.

The JAX package leaves the int8 convolution to XLA: no Pallas kernel is
replaced here. Eager PyTorch has no int8 convolution on CUDA, so on the
card each conv is an im2col of the padded int8 activations (a strided
view copied once into an (M, K) int8 matrix) and one ``torch._int_mm``
into int32, a library call (cuBLASLt's IMMA product), like a plain
matrix product that XLA would run. What bounds it is not the product:
the im2col writes kh * kw bytes for every input byte (FaceResNet100's
first-unit conv1 at 64 crops: 802,816 x 576 int8, 462 MB, plus a 205 MB
int32 result), and each conv takes some dozen eager launches (the scale,
the rounding, the pad, the im2col copy, the product, the dequantisation)
where a cuDNN conv takes one. ``quant_conv.launches`` counts the
``_int_mm`` calls.

On the CPU, :func:`quant_conv` takes the plain version: the same
quantisation, then ``F.conv2d`` of the int8 values in float64. That is
exact: every product and partial sum is an integer below 127 * 127 *
9072 < 2**53 (float32, exact only below 2**24, is not).

Layout: activations are NHWC, as in the JAX package; weights are OIHW
(``weight_q``), and the product's (K, N) matrix is built once per conv
(:func:`conv_weight_matrix`).
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from terran_tpu_torch.runtime import device_constant
from terran_tpu_torch.utils.profiling import profiler_range

QMAX = 127.0
# float32(1 / 127): the jitted JAX program computes the activation scale
# ``max|x| / 127.0`` as a multiply by this constant (XLA rewrites a
# division by a constant so).
QMAX_RECIPROCAL = float(torch.tensor(1.0 / QMAX, dtype=torch.float32))
SCALE_FLOOR = 1e-12
# torch._int_mm on CUDA takes K and N in multiples of 8 and M above 16:
# the matrices are padded with zero rows and columns, which leave every
# sum as it was.
INT_MM_MULTIPLE = 8
INT_MM_MIN_ROWS = 17
# The profiler range of one int8 conv: batch, input height, width and
# channels, output channels, kernel, stride, padding.
CONV_RANGE = "terran::quant_conv n{} h{} w{} c{} o{} k{} s{} p{}"


def _round_up(x, multiple):
    return -(-x // multiple) * multiple


def _weight_scale(max_abs):
    """``max(max_abs / 127, 1e-12)`` in float32, a true division, as the
    JAX package quantises its weights (outside any jit). The divisor is a
    tensor on ``max_abs``'s device: CUDA turns a division by a Python
    scalar into a multiply by its reciprocal."""
    qmax = device_constant(QMAX, torch.float32, max_abs.device)
    return torch.clamp(max_abs / qmax, min=SCALE_FLOOR)


def quantize_conv_weight(weight):
    """An OIHW float32 weight -> (int8 OIHW weight, float32 (O,) scales):
    ``scale = max(max|w| / 127, 1e-12)`` over each output channel (dims
    1-3, the JAX code's HWIO axes 0-2), ``clip(round(w / scale))``, ties
    to even. Quantise from the float32 masters: a weight cast to bf16
    first gives other int8 values and scales."""
    if weight.dtype != torch.float32:
        raise TypeError(f"quantize from float32 weights, got {weight.dtype}")
    scale = _weight_scale(weight.abs().amax(dim=(1, 2, 3)))
    weight_q = torch.clamp(torch.round(weight / scale[:, None, None, None]),
                           -QMAX, QMAX).to(torch.int8)
    return weight_q, scale


def conv_weight_matrix(weight_q):
    """The (K, N) int8 matrix of an OIHW int8 weight for the im2col
    product, K = kh * kw * cin in the patches' (kh, kw, cin) order, padded
    with zeros to multiples of 8 in K and N, column-major (the transpose
    of a contiguous (N, K) matrix)."""
    out_ch = weight_q.shape[0]
    mat = weight_q.permute(0, 2, 3, 1).reshape(out_ch, -1)
    k, n = mat.shape[1], out_ch
    mat = F.pad(mat, (0, _round_up(k, INT_MM_MULTIPLE) - k,
                      0, _round_up(n, INT_MM_MULTIPLE) - n))
    return mat.contiguous().t()


def quantize_activation(x, group=None):
    """(``round(x / xs)`` clipped to +-127, ties to even, as int-valued
    float32, and the 0-d float32 scale ``xs = max(max|x| * float32(1 /
    127), 1e-12)``, as the jitted JAX program computes them). ``xs`` stays
    on ``x``'s device, since reading it on the host would wait for the
    card, and ``x / xs`` is a true division by it. With a process
    ``group``, ``x`` is this rank's rows of a batch split over it, and
    ``max|x|`` is all-reduced over the group: the whole batch's, as XLA
    reduces a sharded tensor."""
    max_abs = x.abs().amax().to(torch.float32)
    if group is not None:
        max_abs = max_abs.reshape(1)
        dist.all_reduce(max_abs, op=dist.ReduceOp.MAX, group=group)
        max_abs = max_abs.reshape(())
    xs = torch.clamp(max_abs * QMAX_RECIPROCAL, min=SCALE_FLOOR)
    return torch.clamp(torch.round(x.to(torch.float32) / xs), -QMAX, QMAX), xs


def conv_int32_plain(xq, weight_q, stride, padding):
    """The exact int32 conv of int-valued NHWC ``xq`` with OIHW int8
    ``weight_q``, computed in float64 (every sum is an integer below
    2**53). On a CUDA tensor cuDNN is kept out, since some of its
    algorithms (FFT, Winograd) do not sum exactly."""
    x = xq.to(torch.float64).permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x, weight_q.to(torch.float64), stride=stride,
                       padding=padding)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def im2col_int8(xq, kernel, stride, padding):
    """The (M, K_pad) int8 patch matrix of int-valued NHWC ``xq``: M = n *
    ho * wo rows (at least 17), K = kh * kw * cin columns in (kh, kw,
    cin) order, zero-padded to a multiple of 8. Returns (cols, (n, ho,
    wo))."""
    n, h, w, c = xq.shape
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    m, k = n * ho * wo, kernel * kernel * c
    rows, cols_k = max(m, INT_MM_MIN_ROWS), _round_up(k, INT_MM_MULTIPLE)
    if kernel == 1 and stride == 1 and padding == 0 and (rows, cols_k) == (
            m, k):
        return xq.to(torch.int8).reshape(m, k), (n, ho, wo)
    if padding:
        padded = torch.zeros((n, h + 2 * padding, w + 2 * padding, c),
                             dtype=torch.int8, device=xq.device)
        padded[:, padding:padding + h, padding:padding + w].copy_(xq)
    else:
        padded = xq.to(torch.int8)
    # (n, ho, wo, c, kh, kw) strided view -> (kh, kw, c) patch order.
    patches = padded.unfold(1, kernel, stride).unfold(2, kernel, stride)
    patches = patches.permute(0, 1, 2, 4, 5, 3)
    new = torch.empty if (rows, cols_k) == (m, k) else torch.zeros
    cols = new((rows, cols_k), dtype=torch.int8, device=xq.device)
    # One copy writes every patch into its row's first K columns.
    cols[:m].view(n, ho, wo, cols_k)[..., :k].unflatten(
        -1, (kernel, kernel, c)).copy_(patches)
    return cols, (n, ho, wo)


def conv_int32_int_mm(xq, weight_mat, out_channels, kernel, stride,
                      padding):
    """The int32 conv of int-valued NHWC ``xq`` as im2col plus one
    ``torch._int_mm`` against ``weight_mat`` (:func:`conv_weight_matrix`);
    counted in ``quant_conv.launches``."""
    cols, (n, ho, wo) = im2col_int8(xq, kernel, stride, padding)
    acc = torch._int_mm(cols, weight_mat)
    quant_conv.launches += 1
    return acc[:n * ho * wo, :out_channels].reshape(n, ho, wo, out_channels)


def dequantize(acc, xs, weight_scale, out_dtype):
    """``(acc.astype(f32) * (xs * scale)).astype(out_dtype)``: the scales
    multiply first; the int32 accumulator converts to float32 (rounding
    to nearest above 2**24) inside the product's type promotion."""
    return (acc * (xs * weight_scale)).to(out_dtype)


def quant_conv_int32(x, weight_q, stride, padding, weight_mat=None,
                     group=None):
    """(int32 NHWC accumulator, 0-d float32 activation scale) of the int8
    conv of NHWC ``x``: on a CUDA tensor im2col + ``torch._int_mm``
    (``weight_mat``, built from ``weight_q`` when None); on a CPU tensor
    the plain version. Any other device raises. ``group``: see
    :func:`quantize_activation`."""
    if x.device.type == "cpu":
        return quant_conv_int32_plain(x, weight_q, stride, padding, group)
    if x.device.type != "cuda":
        raise ValueError(f"quant_conv runs on CUDA or the CPU, not "
                         f"{x.device}")
    if weight_mat is None:
        weight_mat = conv_weight_matrix(weight_q)
    xq, xs = quantize_activation(x, group)
    acc = conv_int32_int_mm(xq, weight_mat, weight_q.shape[0],
                            weight_q.shape[-1], stride, padding)
    return acc, xs


def quant_conv_int32_plain(x, weight_q, stride, padding, group=None):
    """:func:`quant_conv_int32`'s plain version, on any device: the conv
    of the int8 values in float64."""
    xq, xs = quantize_activation(x, group)
    return conv_int32_plain(xq, weight_q, stride, padding), xs


def conv_range(x, weight_q, stride, padding):
    """The ``terran::quant_conv`` profiler range (:data:`CONV_RANGE`) of
    one int8 conv of NHWC ``x`` with OIHW ``weight_q``, from quantisation
    to dequantisation, or the shared no-op context when no profiler
    records. It is named by the conv's own dims, so the work it stands
    for does not depend on how the conv is computed."""
    n, h, w, c = x.shape
    return profiler_range(CONV_RANGE, n, h, w, c, weight_q.shape[0],
                          weight_q.shape[-1], stride, padding)


def quant_conv(x, weight_q, weight_scale, stride, padding, out_dtype,
               weight_mat=None, group=None):
    """int8 conv of NHWC ``x`` with a dynamic per-tensor activation scale,
    dequantised and cast to ``out_dtype`` (``models/quant.py::quant_conv``),
    inside one :func:`conv_range`. ``quant_conv.launches`` counts its
    ``torch._int_mm`` calls."""
    with conv_range(x, weight_q, stride, padding):
        acc, xs = quant_conv_int32(x, weight_q, stride, padding, weight_mat,
                                   group)
        return dequantize(acc, xs, weight_scale, out_dtype)


quant_conv.launches = 0


class QuantConv2d(nn.Module):
    """A square conv with int8 weights: ``weight_q`` (int8 OIHW) and
    ``weight_scale`` (float32 per output channel) are buffers, and the
    product's matrix is derived from them whenever they load. Build it
    and its model in the compute dtype: ``Module.to(dtype)`` would cast
    the float32 scales too. Takes and returns NHWC. ``group``: see
    :func:`reduce_activation_scales`."""

    def __init__(self, in_channels, out_channels, kernel=3, stride=1,
                 padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.register_buffer("weight_q", torch.zeros(
            (out_channels, in_channels, kernel, kernel), dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_channels))
        self.register_buffer("weight_mat", conv_weight_matrix(self.weight_q),
                             persistent=False)
        self.register_load_state_dict_post_hook(QuantConv2d._derive_matrix)
        self.group = None

    @staticmethod
    def _derive_matrix(module, _incompatible_keys):
        module.weight_mat = conv_weight_matrix(module.weight_q)

    def accumulate(self, x):
        """(int32 accumulator, activation scale): :func:`quant_conv_int32`."""
        return quant_conv_int32(x, self.weight_q, self.stride, self.padding,
                                self.weight_mat, self.group)

    def forward(self, x, out_dtype):
        """:func:`quant_conv` of ``x``, cast to ``out_dtype``."""
        return quant_conv(x, self.weight_q, self.weight_scale, self.stride,
                          self.padding, out_dtype, self.weight_mat,
                          self.group)


def reduce_activation_scales(model, group):
    """Make every int8 conv of ``model`` take its activation scale over
    the rows of every rank of the process ``group`` (None: this process's
    rows alone), so that a batch split over the group quantises as the
    whole batch would. Each forward then makes one all-reduce a conv, and
    every rank must run the model together."""
    for module in model.modules():
        if isinstance(module, QuantConv2d):
            module.group = group


def keep_float64_copies(module, *names):
    """Give ``module`` a float64 buffer ``<name>64`` for each parameter
    ``<name>``, made again whenever a state dict loads: the single-rounding
    sums (``torch.addcmul`` in float64) of the int8 models read them."""

    def widen(module, _incompatible_keys=None):
        for name in names:
            setattr(module, f"{name}64",
                    getattr(module, name).detach().to(torch.float64))

    for name in names:
        module.register_buffer(f"{name}64", None, persistent=False)
    widen(module)
    module.register_load_state_dict_post_hook(widen)


def quantize_state_dict(model_or_state_dict, compute_dtype, is_conv,
                        keep_f32=()):
    """An int8 state dict from a float32 master model or state dict: every
    ``<p>.weight`` that ``is_conv(<p>)`` selects becomes ``<p>.weight_q`` +
    ``<p>.weight_scale``; every other float32 entry is cast to
    ``compute_dtype`` unless its name starts with a ``keep_f32`` prefix
    (``quantize_conv_kernels``). Entries already quantised pass through."""
    state_dict = (model_or_state_dict.state_dict()
                  if isinstance(model_or_state_dict, nn.Module)
                  else model_or_state_dict)
    out = {}
    for name, value in state_dict.items():
        prefix, _, leaf = name.rpartition(".")
        if leaf == "weight" and is_conv(prefix):
            out[f"{prefix}.weight_q"], out[f"{prefix}.weight_scale"] = (
                quantize_conv_weight(value))
        elif (value.dtype == torch.float32 and leaf != "weight_scale"
              and not any(name.startswith(k) for k in keep_f32)):
            out[name] = value.to(compute_dtype)
        else:
            out[name] = value
    return out
