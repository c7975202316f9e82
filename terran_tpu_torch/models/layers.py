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


def max_pool_2x2(x):
    """Torch MaxPool2d(kernel=2, stride=2, padding=0) for NCHW (floor
    mode)."""
    return F.max_pool2d(x, kernel_size=2, stride=2)
