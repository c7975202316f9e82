"""Shared building blocks for the inference models (NCHW inside).

Every floating-point conv's bias or folded-BN affine, activation and
residual add run as one pass, :func:`ops.conv_epilogue.conv_epilogue`: on
the card one kernel in place on the conv's output, on the CPU its plain
version."""

import torch
import torch.nn.functional as F
from torch import nn

from terran_tpu_torch.ops.conv_epilogue import conv_epilogue


def biased_conv(conv, x, relu=False, alpha=None):
    """``conv`` (an ``nn.Conv2d`` with a bias) of ``x`` without its bias,
    then one epilogue: the bias, then a ReLU where ``relu``, or the PReLU
    of slopes ``alpha``."""
    return conv_epilogue(conv._conv_forward(x, conv.weight, None),
                         bias=conv.bias, relu=relu, alpha=alpha,
                         inplace=True)


class ConvBias(nn.Conv2d):
    """Plain conv with bias and optional ReLU (no BN), torch-style
    symmetric integer padding."""

    def __init__(self, in_channels, out_channels, kernel=3, stride=1,
                 padding=0, act="none"):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding, bias=True)
        if act not in ("none", "relu"):
            raise ValueError(f"unknown activation {act!r}")
        self.act = act

    def forward(self, x):
        return biased_conv(self, x, relu=self.act == "relu")


class Affine(nn.Module):
    """Folded-BN per-channel affine ``x * scale + bias``, one pass into a
    new tensor."""

    def __init__(self, features):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return conv_epilogue(x, bias=self.bias, scale=self.scale)


class ConvAffine(nn.Module):
    """Conv (no bias) + folded-BN affine + optional activation: torch's
    ``Conv2d(bias=False) -> BatchNorm2d -> act`` at inference time, with
    the BN kept as a separate ``x * scale + bias`` like
    ``terran_tpu/models/layers.py::ConvAffine``. ``groups`` makes the
    conv grouped (depthwise when it equals the channel count). A PReLU's
    slopes belong to the caller, which passes them to ``forward``."""

    def __init__(self, in_channels, features, kernel=3, stride=1, padding=0,
                 groups=1, act="relu"):
        super().__init__()
        if act not in ("none", "relu"):
            raise ValueError(f"unknown activation {act!r}")
        self.conv = nn.Conv2d(in_channels, features, kernel, stride=stride,
                              padding=padding, groups=groups, bias=False)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.act = act

    def forward(self, x, alpha=None, residual=None):
        """The conv of ``x``, then one epilogue: the affine, the module's
        ReLU or the PReLU of the caller's slopes ``alpha``, then the add of
        ``residual`` where given."""
        return conv_epilogue(self.conv(x), bias=self.bias, scale=self.scale,
                             relu=self.act == "relu", alpha=alpha,
                             residual=residual, inplace=True)


def upsample2x_nearest(x, out_h, out_w):
    """Nearest-neighbour 2x upsample of NCHW ``x``, cropped to
    (out_h, out_w): ``F.interpolate(scale_factor=2)`` then slicing, as the
    reference FPN does."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return x[:, :, :out_h, :out_w]


def max_pool_2x2(x):
    """Torch MaxPool2d(kernel=2, stride=2, padding=0) for NCHW (floor
    mode)."""
    return F.max_pool2d(x, kernel_size=2, stride=2)
