"""The epilogue of a floating-point conv in one pass.

After each bf16 or float32 conv of the models (``models/layers.py``,
``models/arcface.py``, ``models/body25.py``, the RetinaFace heads) comes
its epilogue: the per-channel bias or folded-BatchNorm affine ``x * scale
+ bias``, then no activation, a ReLU or a per-channel PReLU, then, where
the module has one, the residual add. :func:`conv_epilogue` runs it as
one launch of ``csrc/conv_epilogue.cu`` (built by ``nvcc`` at first use)
for a CUDA tensor, in place on the conv's fresh output, and as
:func:`conv_epilogue_plain` for a CPU tensor; any other device raises.

The kernel replaces no Pallas kernel: the JAX package leaves these ops to
XLA, which fuses them into the convolution. Eager PyTorch ran each as a
launch of its own, 2 to 6 a conv, each reading and writing the whole
activation through its generic element-wise kernel (the per-channel
operand against a channels-last conv output). What bounds the kernel is
bytes: the output read and written once, plus the residual read; the
note in the source says what its design does about them.

:func:`conv_epilogue_plain` is the definition of the result: the same ops
in float32, in the eager chain's order, with one rounding to the
tensor's dtype at the end, where the eager chain in bf16 rounded after
each op. In float32 it is the eager chain itself. The kernel equals it
bit for bit.

``conv_epilogue.launches``, a Counter, counts the kernel's launches by
mode (:func:`mode`), where it launches.
"""

import collections
import contextlib
import ctypes

import torch

_SOURCE = "conv_epilogue.cu"
# The kernel's element types and activations (csrc/conv_epilogue.cu).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NONE, RELU, PRELU = 0, 1, 2
_lib = None


def mode(bias=None, scale=None, relu=False, alpha=None, residual=None):
    """The epilogue's name, as ``conv_epilogue.launches`` counts it:
    'affine' (a scale, with or without a bias), 'bias' or 'none', then
    '+relu' or '+prelu', then '+residual'. Raises where both a ReLU and a
    PReLU are asked for."""
    if relu and alpha is not None:
        raise ValueError("an epilogue takes a ReLU or a PReLU, not both")
    name = ("affine" if scale is not None
            else "bias" if bias is not None else "none")
    if relu:
        name += "+relu"
    elif alpha is not None:
        name += "+prelu"
    if residual is not None:
        name += "+residual"
    return name


def _channels(v, x):
    """A per-channel vector in ``x``'s dtype, widened to float32, as an
    NCHW-broadcastable tensor."""
    return v.to(x.dtype).to(torch.float32).reshape(1, -1, 1, 1)


def conv_epilogue_plain(x, bias=None, scale=None, relu=False, alpha=None,
                        residual=None):
    """``act(x * scale + bias) + residual`` of NCHW ``x`` (any layout) in
    float32, in that order, rounded once to ``x``'s dtype: the scale, the
    bias, the residual and the PReLU's ``alpha`` where given, ``act`` a
    ReLU (``torch.relu``), a PReLU (``where(v >= 0, v, v * alpha)``, the
    JAX models' form) or none. Per-channel vectors are taken in ``x``'s
    dtype first, as the eager chain broadcast them."""
    mode(bias, scale, relu, alpha, residual)
    v = x.to(torch.float32)
    if scale is not None:
        v = v * _channels(scale, x)
    if bias is not None:
        v = v + _channels(bias, x)
    if relu:
        v = torch.relu(v)
    elif alpha is not None:
        v = torch.where(v >= 0, v, v * _channels(alpha, x))
    if residual is not None:
        v = v + residual.to(torch.float32)
    return v.to(x.dtype)


def _library():
    global _lib
    if _lib is None:
        from terran_tpu_torch.utils.cuda_build import load_library

        lib = load_library(_SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.conv_epilogue.argtypes = [ptr] * 6 + [i64, i64, i32, i32, i32,
                                                  ptr]
        lib.conv_epilogue.restype = i32
        lib.conv_epilogue_prepare.argtypes = []
        lib.conv_epilogue_prepare.restype = i32
        err = lib.conv_epilogue_prepare()
        if err != 0:
            raise RuntimeError(f"conv_epilogue_prepare failed: CUDA error "
                               f"{err}")
        _lib = lib
    return _lib


def channel_run(x):
    """The elements of one channel that lie together in memory: 1 for a
    channels-last 4-d tensor, H * W for a contiguous NCHW one; raises on
    any other layout."""
    if x.dim() != 4:
        raise ValueError(f"the conv epilogue takes NCHW tensors, not "
                         f"{tuple(x.shape)}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    if x.is_contiguous():
        return x.shape[2] * x.shape[3]
    raise ValueError(f"no conv epilogue kernel for strides {x.stride()} "
                     f"of shape {tuple(x.shape)}: channels-last or "
                     "contiguous NCHW")


def _check(x, run, residual, vectors):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"no conv epilogue kernel for {x.dtype}: float32 "
                        "or bfloat16")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device or channel_run(residual) != run):
        raise ValueError("the residual must have the conv output's shape, "
                         "dtype, device and layout")
    for v in vectors:
        if v is not None and (v.shape != (x.shape[1],) or v.dtype != x.dtype
                              or v.device != x.device
                              or not v.is_contiguous()):
            raise ValueError(f"a per-channel vector must be {x.shape[1]} "
                             f"contiguous values of the output's dtype "
                             f"({x.dtype}) on {x.device}")


def _on(device):
    """The guard for launches on ``device``: none where it is current."""
    if device.index == torch.cuda.current_device():
        return _NO_GUARD
    return torch.cuda.device(device)


_NO_GUARD = contextlib.nullcontext()


def conv_epilogue_kernel(x, bias=None, scale=None, relu=False, alpha=None,
                         residual=None, inplace=False):
    """:func:`conv_epilogue_plain` of CUDA ``x`` in one launch of
    ``csrc/conv_epilogue.cu``, into ``x`` itself where ``inplace`` (the
    conv's fresh output), else into a new tensor of its layout. Raises on
    a dtype, layout or operand the kernel does not take."""
    name = mode(bias, scale, relu, alpha, residual)
    run = channel_run(x)
    _check(x, run, residual, (bias, scale, alpha))
    out = x if inplace else torch.empty_like(x)
    if x.numel() == 0:
        return out
    dev = x.device
    act = RELU if relu else NONE if alpha is None else PRELU
    with _on(dev):
        err = _library().conv_epilogue(
            x.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr()
              for t in (residual, scale, bias, alpha)),
            x.numel(), run, x.shape[1], act, _DTYPE_CODES[x.dtype],
            torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"conv_epilogue failed on {tuple(x.shape)} "
                           f"({name}): CUDA error {err}")
    conv_epilogue.launches[name] += 1
    return out


def conv_epilogue(x, bias=None, scale=None, relu=False, alpha=None,
                  residual=None, inplace=False):
    """The epilogue of a conv's NCHW output ``x``: on a CUDA tensor
    :func:`conv_epilogue_kernel` (in place where ``inplace``), on a CPU
    tensor :func:`conv_epilogue_plain`; any other device raises."""
    if x.device.type == "cpu":
        return conv_epilogue_plain(x, bias, scale, relu, alpha, residual)
    if x.device.type != "cuda":
        raise ValueError(f"no conv epilogue on {x.device}")
    return conv_epilogue_kernel(x, bias, scale, relu, alpha, residual,
                                inplace)


conv_epilogue.launches = collections.Counter()
