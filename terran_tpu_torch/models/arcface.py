"""ArcFace LResNet100E-IR in PyTorch.

The port of ``terran_tpu/models/arcface.py``, which re-implements the
reference ``FaceResNet100`` (arcface/model.py:38-97): pre-activation
residual units (BN-Conv-BN-PReLU-Conv-BN, with a conv shortcut on the
stride-2 unit of each stage), stages [3, 13, 30, 3] at channels
[64, 64, 128, 256, 512], preprocessing ``(x - 127.5) * 0.0078125`` in
float32, and a BN-Flatten-Linear-BN1d head whose BN1d the converter folds
into the linear layer. Dropout is inference-disabled and omitted.

Inputs are NHWC RGB crops in [0, 255] (the converter folds the reference's
BGR flip into the first conv); the trunk runs NCHW in the compute dtype
(cuDNN on the card). The ``embed`` projection stays float32 and flattens
the (7, 7, 512) map in (h, w, C) order, the order of the JAX model's
Dense kernel.
"""

import torch
from torch import nn

from terran_tpu_torch.models.layers import Affine, ConvAffine
from terran_tpu_torch.models.quant import (
    QuantConv2d, keep_float64_copies, quantize_state_dict,
)

UNITS_PER_STAGE = (3, 13, 30, 3)
CHANNELS = (64, 64, 128, 256, 512)
PREPROC_MEAN = 127.5
PREPROC_STD = 0.0078125
EMBEDDING_DIM = 512


class Unit(nn.Module):
    """Pre-activation residual unit (arcface/model.py:4-35): ``pre`` one
    pass, ``conv1``'s epilogue with the unit's PReLU, ``conv2``'s with the
    shortcut (or ``x``) added."""

    def __init__(self, in_channels, features, stride=1, has_shortcut=False):
        super().__init__()
        self.pre = Affine(in_channels)
        self.conv1 = ConvAffine(in_channels, features, 3, 1, 1, act="none")
        self.prelu = nn.Parameter(torch.full((features,), 0.25))
        self.conv2 = ConvAffine(features, features, 3, stride, 1, act="none")
        self.shortcut = (
            ConvAffine(in_channels, features, 1, stride, 0, act="none")
            if has_shortcut else None
        )

    def forward(self, x):
        body = self.conv1(self.pre(x), alpha=self.prelu)
        shortcut = self.shortcut(x) if self.shortcut is not None else x
        return self.conv2(body, residual=shortcut)


class FaceResNet100(nn.Module):
    """(B, 112, 112, 3) crops -> unnormalised (B, 512) float32 features."""

    def __init__(self):
        super().__init__()
        self.initial = ConvAffine(3, CHANNELS[0], 3, 1, 1, act="none")
        self.initial_prelu = nn.Parameter(torch.full((CHANNELS[0],), 0.25))
        for stage_idx, num_units in enumerate(UNITS_PER_STAGE):
            for unit_idx in range(num_units):
                cin = CHANNELS[stage_idx + (unit_idx > 0)]
                self.add_module(
                    f"stage{stage_idx}_unit{unit_idx}",
                    Unit(cin, CHANNELS[stage_idx + 1],
                         stride=2 if unit_idx == 0 else 1,
                         has_shortcut=unit_idx == 0),
                )
        self.head_pre = Affine(CHANNELS[-1])
        self.embed = nn.Linear(7 * 7 * CHANNELS[-1], EMBEDDING_DIM)

    @classmethod
    def from_state_dict(cls, state_dict, dtype=torch.float32):
        """The model in ``dtype`` but for ``embed``, which computes in
        float32 and so keeps float32 weights; the weights are not
        loaded."""
        model = cls().to(dtype=dtype)
        model.embed.to(torch.float32)
        return model

    @property
    def compute_dtype(self):
        return self.initial.conv.weight.dtype

    def forward(self, x):
        x = ((x.to(torch.float32) - PREPROC_MEAN) * PREPROC_STD).to(
            self.compute_dtype)
        x = x.permute(0, 3, 1, 2)
        x = self.initial(x, alpha=self.initial_prelu)
        for stage_idx, num_units in enumerate(UNITS_PER_STAGE):
            for unit_idx in range(num_units):
                x = getattr(self, f"stage{stage_idx}_unit{unit_idx}")(x)
        x = self.head_pre(x)
        # Flatten in (h, w, C) order, then project in float32.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)
        return torch.matmul(x, self.embed.weight.t()) + self.embed.bias


def normalize_embeddings(features):
    """L2-normalise embeddings (reference: sklearn normalize,
    wrapper.py:176)."""
    norm = torch.sqrt(torch.sum(features * features, dim=-1, keepdim=True))
    return features / torch.clamp(norm, min=1e-12)


# ---------------------------------------------------------------------------
# Opt-in int8 trunk (terran_tpu/models/arcface.py::apply_int8)
# ---------------------------------------------------------------------------
# Every trunk conv runs int8 x int8 -> int32 with per-output-channel
# static weight scales and a per-tensor dynamic activation scale
# (models/quant.py); the folded-BN affines, the PReLUs and head_pre run
# in the compute dtype, the 'embed' projection in float32. The trunk is
# NHWC, the JAX layout, so each conv's im2col reads channels last.


def _prelu_nhwc(x, alpha):
    return torch.where(x >= 0, x, x * alpha.to(x.dtype))


class _Int8Affine(nn.Module):
    """The folded-BN affine ``x * scale + bias`` with one rounding to the
    compute dtype: XLA compiles the JAX package's ``_affine`` into a fused
    multiply-add, and every rounding here decides the next conv's int8
    values. The product and the sum run in float64, where ``x * scale``
    is exact, from float64 copies of the parameters made when they
    load."""

    def __init__(self, features, dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype))
        keep_float64_copies(self, "scale", "bias")

    def forward(self, x):
        return torch.addcmul(self.bias64, x, self.scale64).to(x.dtype)


class _Int8ConvAffine(_Int8Affine):
    """``_quant_conv_affine``: the int8 conv cast to the compute dtype,
    then the folded-BN affine in it (``quant.epilogue_plain``'s affine
    mode; on the card one kernel after the product)."""

    def __init__(self, in_channels, features, kernel, stride, padding,
                 dtype):
        super().__init__(features, dtype)
        self.conv = QuantConv2d(in_channels, features, kernel, stride,
                                padding)

    def forward(self, x):
        return self.conv(x, self.scale.dtype, bias64=self.bias64,
                         scale64=self.scale64)


class _Int8Unit(nn.Module):
    def __init__(self, in_channels, features, stride, has_shortcut, dtype):
        super().__init__()
        self.pre = _Int8Affine(in_channels, dtype)
        self.conv1 = _Int8ConvAffine(in_channels, features, 3, 1, 1, dtype)
        self.prelu = nn.Parameter(torch.full((features,), 0.25, dtype=dtype))
        self.conv2 = _Int8ConvAffine(features, features, 3, stride, 1, dtype)
        self.shortcut = (
            _Int8ConvAffine(in_channels, features, 1, stride, 0, dtype)
            if has_shortcut else None
        )

    def forward(self, x):
        body = _prelu_nhwc(self.conv1(self.pre(x)), self.prelu)
        body = self.conv2(body)
        return body + (self.shortcut(x) if self.shortcut is not None else x)


class Int8FaceResNet100(nn.Module):
    """FaceResNet100 with int8 trunk convs, built in ``compute_dtype``;
    its state dict comes from :func:`quantize_params` (or, carried from the
    JAX package, ``params_from_jax`` of its ``quantize_params`` tree).
    (B, 112, 112, 3) crops -> unnormalised (B, 512) float32 features."""

    def __init__(self, compute_dtype=torch.float32):
        super().__init__()
        dt = compute_dtype
        self.initial = _Int8ConvAffine(3, CHANNELS[0], 3, 1, 1, dt)
        self.initial_prelu = nn.Parameter(
            torch.full((CHANNELS[0],), 0.25, dtype=dt))
        for stage_idx, num_units in enumerate(UNITS_PER_STAGE):
            for unit_idx in range(num_units):
                cin = CHANNELS[stage_idx + (unit_idx > 0)]
                self.add_module(
                    f"stage{stage_idx}_unit{unit_idx}",
                    _Int8Unit(cin, CHANNELS[stage_idx + 1],
                              2 if unit_idx == 0 else 1, unit_idx == 0, dt),
                )
        self.head_pre = _Int8Affine(CHANNELS[-1], dt)
        self.embed = nn.Linear(7 * 7 * CHANNELS[-1], EMBEDDING_DIM)

    @property
    def compute_dtype(self):
        return self.initial.scale.dtype

    def forward(self, x):
        x = ((x.to(torch.float32) - PREPROC_MEAN) * PREPROC_STD).to(
            self.compute_dtype)
        x = _prelu_nhwc(self.initial(x), self.initial_prelu)
        for stage_idx, num_units in enumerate(UNITS_PER_STAGE):
            for unit_idx in range(num_units):
                x = getattr(self, f"stage{stage_idx}_unit{unit_idx}")(x)
        x = self.head_pre(x)
        # NHWC flattens in (h, w, C) order; project in float32.
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        return torch.matmul(x, self.embed.weight.t()) + self.embed.bias


def quantize_params(model_or_state_dict, compute_dtype=torch.float32):
    """The :class:`Int8FaceResNet100` state dict of a float32
    :class:`FaceResNet100` (or its state dict): every trunk conv int8 +
    per-channel scales, the affines and PReLUs cast to ``compute_dtype``,
    the 'embed' head kept float32."""
    return quantize_state_dict(
        model_or_state_dict, compute_dtype,
        is_conv=lambda prefix: prefix.endswith(".conv"), keep_f32=("embed",),
    )
