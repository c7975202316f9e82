"""Int8 post-training quantisation for the opt-in trunks.

The port of ``terran_tpu/models/quant.py``: symmetric static weight
scales, one per output channel (:func:`quantize_conv_weight`), and a
symmetric dynamic scale for the whole activation tensor, ``max|x| / 127``
(:func:`quant_conv`). The int8 x int8 -> int32 products are exact; the
two scales fold into one float32 multiply on the way out, in the JAX
operation order ``acc * (xs * scale)``.

The JAX package leaves the int8 convolution to XLA: no Pallas kernel is
replaced here. Eager PyTorch has no int8 convolution on CUDA, so on the
card each conv is an int8 im2col matrix times the int8 weight matrix in
one ``torch._int_mm`` into int32, a library call (cuBLASLt's IMMA
product), like a plain matrix product that XLA would run. Around it run
three kernels of ``csrc/quant_conv.cu`` (built by ``nvcc`` at first use):
the activation's ``max|x|`` (:func:`quantize_im2col`, with the group's
all-reduce after it), the quantisation written straight into the padded
column matrix, and after the product the dequantisation fused with its
module's bias and ReLU or its folded-BatchNorm affine
(:func:`dequant_epilogue`): four launches a conv and one memset. What
bounds them is bytes: the column matrix holds kh * kw bytes for every
input element (FaceResNet100's first-unit conv1 at 64 crops: 802,816 x
576 int8, 462 MB, and a 205 MB int32 product). ``quant_conv.launches``
counts the ``_int_mm`` calls; ``quant_conv.fused``, a Counter, each
kernel's launches by its name, counted where it launches, so on the
card every name's count equals ``quant_conv.launches``.

Their plain versions are the eager passes they replace, kept for the
tests and the card's checks of each stage: :func:`quantize_activation`,
:func:`im2col_int8`, :func:`conv_int32_int_mm`, :func:`dequantize` and
:func:`epilogue_plain`. On the CPU, :func:`quant_conv` takes
:func:`quant_conv_plain`: the same quantisation, then ``F.conv2d`` of the
int8 values in float64. That is exact: every product and partial sum is
an integer below 127 * 127 * 9072 < 2**53 (float32, exact only below
2**24, is not).

Layout: activations are NHWC, as in the JAX package; weights are OIHW
(``weight_q``), and the product's (K, N) matrix is built once per conv
(:func:`conv_weight_matrix`).
"""

import collections
import contextlib
import ctypes

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
# The epilogue modes of csrc/quant_conv.cu's dequant_epilogue_kernel, one
# a caller: quant_conv's dequantisation, OpenPose's conv + bias [+ ReLU],
# ArcFace's conv + folded-BatchNorm affine (:func:`epilogue_plain`).
DEQUANTIZE, BIAS, AFFINE = 0, 1, 2
_SOURCE = "quant_conv.cu"
# The kernels that quantize_im2col and dequant_epilogue launch, as
# quant_conv.fused counts them.
QUANTIZE_KERNELS = ("absmax_kernel", "quantize_im2col_kernel")
EPILOGUE_KERNEL = "dequant_epilogue_kernel"
# The kernels' element types (csrc/quant_conv.cu: kFloat32, kBFloat16).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


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


def conv_dims(x, kernel, stride, padding):
    """(n, ho, wo, rows, k_pad) of the im2col product of NHWC ``x``: the
    output's batch and sides, the column matrix's rows (n * ho * wo, at
    least 17) and its K = kernel**2 * channels columns padded to a
    multiple of 8."""
    n, h, w, c = x.shape
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"a {kernel}x{kernel} conv at padding {padding} "
                         f"has no output on a {h}x{w} input")
    return (n, ho, wo, max(n * ho * wo, INT_MM_MIN_ROWS),
            _round_up(kernel * kernel * c, INT_MM_MULTIPLE))


def im2col_int8(xq, kernel, stride, padding):
    """The (M, K_pad) int8 patch matrix of int-valued NHWC ``xq``: M = n *
    ho * wo rows (at least 17), K = kh * kw * cin columns in (kh, kw,
    cin) order, zero-padded to a multiple of 8. Returns (cols, (n, ho,
    wo)). The plain version of quantize_im2col_kernel's writes."""
    n, h, w, c = xq.shape
    _, ho, wo, rows, cols_k = conv_dims(xq, kernel, stride, padding)
    m, k = n * ho * wo, kernel * kernel * c
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
    """The int32 conv of int-valued NHWC ``xq`` as the eager im2col plus
    one ``torch._int_mm`` against ``weight_mat``
    (:func:`conv_weight_matrix`); counted in ``quant_conv.launches``."""
    cols, (n, ho, wo) = im2col_int8(xq, kernel, stride, padding)
    acc = torch._int_mm(cols, weight_mat)
    quant_conv.launches += 1
    return acc[:n * ho * wo, :out_channels].reshape(n, ho, wo, out_channels)


def dequantize(acc, xs, weight_scale, out_dtype):
    """``(acc.astype(f32) * (xs * scale)).astype(out_dtype)``: the scales
    multiply first; the int32 accumulator converts to float32 (rounding
    to nearest above 2**24) inside the product's type promotion."""
    return (acc * (xs * weight_scale)).to(out_dtype)


def epilogue_mode(bias64, scale64, relu):
    """The epilogue a module's arguments select: no ``bias64``, the
    dequantisation; ``bias64`` alone, bias [+ ReLU]; both, the affine.
    ``relu`` goes only with the bias."""
    mode = (DEQUANTIZE if bias64 is None
            else BIAS if scale64 is None else AFFINE)
    if relu and mode != BIAS:
        raise ValueError("relu follows only the bias epilogue")
    if bias64 is None and scale64 is not None:
        raise ValueError("the affine epilogue takes bias64 and scale64")
    return mode


def epilogue_plain(acc, xs, weight_scale, out_dtype, bias64=None,
                   scale64=None, relu=False):
    """The int32 accumulator to the conv's output in ``out_dtype`` by
    eager passes, in the mode :func:`epilogue_mode` selects:

    - :func:`dequantize`;
    - ``bias64 + acc * (xs * scale)`` in float64, where the product of
      two float32 values is exact, rounded once to float32 (XLA compiles
      the JAX package's ``acc * (xs * scale) + bias`` into a fused
      multiply-add, and that rounding decides the next conv's int8
      values), then the ReLU, then the cast (OpenPose's ``conv``);
    - the dequantised value in ``out_dtype``, then ``bias64 + value *
      scale64`` in float64 with one rounding, cast to ``out_dtype``
      (ArcFace's ``_quant_conv_affine``).

    The plain version of dequant_epilogue_kernel."""
    mode = epilogue_mode(bias64, scale64, relu)
    if mode == BIAS:
        y = torch.addcmul(bias64, acc.to(torch.float32),
                          xs * weight_scale).to(torch.float32)
        if relu:
            y = torch.relu(y)
        return y.to(out_dtype)
    y = dequantize(acc, xs, weight_scale, out_dtype)
    if mode == AFFINE:
        y = torch.addcmul(bias64, y, scale64).to(out_dtype)
    return y


def _library():
    global _lib
    if _lib is None:
        from terran_tpu_torch.utils.cuda_build import load_library

        lib = load_library(_SOURCE)
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        lib.quant_conv_absmax.argtypes = [ptr, i64, i32, ptr, ptr]
        lib.quant_conv_im2col.argtypes = (
            [ptr] + [i32] * 13 + [ptr, f32, f32, ptr, ptr, ptr])
        lib.quant_conv_epilogue.argtypes = (
            [ptr] + [i32] * 5 + [ptr] * 5 + [i32, ptr])
        for fn in (lib.quant_conv_absmax, lib.quant_conv_im2col,
                   lib.quant_conv_epilogue):
            fn.restype = i32
        _lib = lib
    return _lib


def _dtype_code(t):
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"no quant_conv kernel for {t.dtype}: float32 or "
                        "bfloat16")
    return code


def _on(device):
    """The guard for launches on ``device``: none where it is current."""
    if device.index == torch.cuda.current_device():
        return _NO_GUARD
    return torch.cuda.device(device)


_NO_GUARD = contextlib.nullcontext()


def _launch(fn, device, *args):
    """``fn(*args, stream)`` on ``device``'s current stream; raises on its
    CUDA error."""
    err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def quantize_im2col(x, kernel, stride, padding, group=None):
    """The kernels' quantisation of NHWC CUDA ``x`` for a ``kernel`` x
    ``kernel`` conv: absmax_kernel's ``max|x|``, all-reduced over the
    process ``group`` (see :func:`quantize_activation`), then
    quantize_im2col_kernel's scale and column matrix. Returns (cols
    (rows, K_pad) int8, scalars, (n, ho, wo)), ``scalars`` the float32
    pair (``max|x|``, ``xs``); equal byte for byte to
    :func:`quantize_activation` and :func:`im2col_int8`."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no quant_conv kernel on {dev}")
    if x.numel() == 0:
        raise ValueError("the activation's max|x| needs an element")
    x = x.contiguous()
    code = _dtype_code(x)
    n, ho, wo, rows, k_pad = conv_dims(x, kernel, stride, padding)
    lib = _library()
    scalars = torch.empty(2, dtype=torch.float32, device=dev)
    cols = torch.empty((rows, k_pad), dtype=torch.int8, device=dev)
    max_abs = scalars.data_ptr()
    with _on(dev):
        if group is not None:
            _launch(lib.quant_conv_absmax, dev, x.data_ptr(), x.numel(),
                    code, max_abs)
            dist.all_reduce(scalars[:1], op=dist.ReduceOp.MAX, group=group)
        _launch(lib.quant_conv_im2col, dev, x.data_ptr(), code, *x.shape,
                kernel, stride, padding, ho, wo, rows, k_pad,
                int(group is None), max_abs, QMAX_RECIPROCAL, SCALE_FLOOR,
                max_abs + 4, cols.data_ptr())
    quant_conv.fused.update(QUANTIZE_KERNELS)
    return cols, scalars, (n, ho, wo)


def dequant_epilogue(acc, scalars, dims, out_channels, weight_scale,
                     out_dtype, bias64=None, scale64=None, relu=False):
    """dequant_epilogue_kernel on the padded (rows, N_pad) int32 CUDA
    product ``acc`` with the activation scale of :func:`quantize_im2col`'s
    ``scalars``: its first prod(``dims``) rows and ``out_channels``
    columns to a new ``dims + (out_channels,)`` tensor in ``out_dtype``,
    equal to :func:`epilogue_plain` in the same mode."""
    mode = epilogue_mode(bias64, scale64, relu)
    if acc.dtype != torch.int32 or not acc.is_contiguous():
        raise ValueError("the epilogue reads a contiguous int32 product")
    if weight_scale.dtype != torch.float32:
        raise TypeError(f"weight scales are float32, not "
                        f"{weight_scale.dtype}")
    for extra in (bias64, scale64):
        if extra is not None and extra.dtype != torch.float64:
            raise TypeError(f"the epilogue's bias and scale are float64 "
                            f"copies, not {extra.dtype}")
    dev = acc.device
    out = torch.empty(tuple(dims) + (out_channels,), dtype=out_dtype,
                      device=dev)
    with _on(dev):
        _launch(_library().quant_conv_epilogue, dev, acc.data_ptr(),
                out.numel() // out_channels, acc.shape[1], out_channels,
                mode, int(relu), scalars.data_ptr() + 4,
                weight_scale.data_ptr(),
                None if bias64 is None else bias64.data_ptr(),
                None if scale64 is None else scale64.data_ptr(),
                out.data_ptr(), _dtype_code(out))
    quant_conv.fused[EPILOGUE_KERNEL] += 1
    return out


def quant_conv_int32_plain(x, weight_q, stride, padding, group=None):
    """(int32 NHWC accumulator, 0-d float32 activation scale) of the int8
    conv of NHWC ``x``, on any device: :func:`quantize_activation`
    (``group``: see there), then the conv of the int8 values in
    float64."""
    xq, xs = quantize_activation(x, group)
    return conv_int32_plain(xq, weight_q, stride, padding), xs


def _check_device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quant_conv runs on CUDA or the CPU, not "
                         f"{x.device}")


def conv_range(x, weight_q, stride, padding):
    """The ``terran::quant_conv`` profiler range (:data:`CONV_RANGE`) of
    one int8 conv of NHWC ``x`` with OIHW ``weight_q``, from quantisation
    to its epilogue, or the shared no-op context when no profiler
    records. It is named by the conv's own dims, so the work it stands
    for does not depend on how the conv is computed."""
    n, h, w, c = x.shape
    return profiler_range(CONV_RANGE, n, h, w, c, weight_q.shape[0],
                          weight_q.shape[-1], stride, padding)


def quant_conv_kernels(x, weight_q, weight_scale, stride, padding,
                       out_dtype, weight_mat=None, group=None, bias64=None,
                       scale64=None, relu=False):
    """:func:`quant_conv` on a CUDA tensor: :func:`quantize_im2col`
    (absmax_kernel, [the group's all-reduce,] quantize_im2col_kernel),
    ``torch._int_mm`` against ``weight_mat`` (built from ``weight_q`` when
    None) and :func:`dequant_epilogue`."""
    if weight_mat is None:
        weight_mat = conv_weight_matrix(weight_q)
    cols, scalars, dims = quantize_im2col(x, weight_q.shape[-1], stride,
                                          padding, group)
    acc = torch._int_mm(cols, weight_mat)
    quant_conv.launches += 1
    return dequant_epilogue(acc, scalars, dims, weight_q.shape[0],
                            weight_scale, out_dtype, bias64, scale64, relu)


def quant_conv_plain(x, weight_q, weight_scale, stride, padding, out_dtype,
                     weight_mat=None, group=None, bias64=None, scale64=None,
                     relu=False):
    """:func:`quant_conv_kernels`' plain version, on any device: the
    float64 conv of the int8 values and :func:`epilogue_plain`
    (``weight_mat`` is not read)."""
    acc, xs = quant_conv_int32_plain(x, weight_q, stride, padding, group)
    return epilogue_plain(acc, xs, weight_scale, out_dtype, bias64, scale64,
                          relu)


def quant_conv(x, weight_q, weight_scale, stride, padding, out_dtype,
               weight_mat=None, group=None, bias64=None, scale64=None,
               relu=False):
    """int8 conv of NHWC ``x`` with a dynamic per-tensor activation scale,
    dequantised to ``out_dtype`` (``models/quant.py::quant_conv``), with
    the bias [+ ReLU] or the affine of :func:`epilogue_plain` where
    ``bias64`` [and ``scale64``] are given, inside one :func:`conv_range`:
    on a CUDA tensor :func:`quant_conv_kernels`, on a CPU tensor
    :func:`quant_conv_plain`; any other device raises.
    ``quant_conv.launches`` counts its ``torch._int_mm`` calls,
    ``quant_conv.fused`` the kernels' launches by name."""
    _check_device(x)
    conv = quant_conv_kernels if x.device.type == "cuda" else quant_conv_plain
    with conv_range(x, weight_q, stride, padding):
        return conv(x, weight_q, weight_scale, stride, padding, out_dtype,
                    weight_mat, group, bias64, scale64, relu)


quant_conv.launches = 0
quant_conv.fused = collections.Counter()


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

    def forward(self, x, out_dtype, bias64=None, scale64=None, relu=False):
        """:func:`quant_conv` of ``x`` to ``out_dtype``, with the epilogue
        that ``bias64``, ``scale64`` and ``relu`` select."""
        return quant_conv(x, self.weight_q, self.weight_scale, self.stride,
                          self.padding, out_dtype, self.weight_mat,
                          self.group, bias64, scale64, relu)


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
