"""Shared building blocks for the inference models (NCHW inside)."""

import torch
import torch.nn.functional as F
from torch import nn


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
        x = super().forward(x)
        return torch.relu(x) if self.act == "relu" else x


def _channels(v, x):
    """A per-channel vector as an NCHW-broadcastable tensor of x's dtype."""
    return v.to(x.dtype).reshape(1, -1, 1, 1)


def prelu(x, alpha):
    """``where(x >= 0, x, x * alpha)`` per channel, as the JAX models
    write it."""
    return torch.where(x >= 0, x, x * _channels(alpha, x))


class Affine(nn.Module):
    """Folded-BN per-channel affine ``x * scale + bias``."""

    def __init__(self, features):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * _channels(self.scale, x) + _channels(self.bias, x)


class ConvAffine(nn.Module):
    """Conv (no bias) + folded-BN affine + optional activation: torch's
    ``Conv2d(bias=False) -> BatchNorm2d -> act`` at inference time, with
    the BN kept as a separate ``x * scale + bias`` in the compute dtype
    like ``terran_tpu/models/layers.py::ConvAffine``. ``groups`` makes the
    conv grouped (depthwise when it equals the channel count)."""

    def __init__(self, in_channels, features, kernel=3, stride=1, padding=0,
                 groups=1, act="relu"):
        super().__init__()
        if act not in ("none", "relu", "prelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.conv = nn.Conv2d(in_channels, features, kernel, stride=stride,
                              padding=padding, groups=groups, bias=False)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        if act == "prelu":
            self.prelu = nn.Parameter(torch.full((features,), 0.25))
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        x = x * _channels(self.scale, x) + _channels(self.bias, x)
        if self.act == "relu":
            return torch.relu(x)
        if self.act == "prelu":
            return prelu(x, self.prelu)
        return x


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
