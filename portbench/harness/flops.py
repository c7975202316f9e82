"""Operations of the models' convolutions, dense layers and products of
two activations, counted from their shapes: 2 x (multiply-adds) of
each, as ``torch.utils.flop_counter`` counts them. Each family's
reference forward (named by its binding under ``families/``) runs on the
``meta`` device with a counting ``ops`` object, so nothing is computed
and the layer list cannot drift from the reference's."""

import functools
import math

import torch

from harness import families
from reference.models import Float


class _Counting(Float):
    def __init__(self):
        self.flops = 0

    def conv(self, x, w, b, stride=1, pad=0, groups=1):
        y = super().conv(x, w, b, stride, pad, groups)
        n, c_out, h, w_out = y.shape
        self.flops += 2 * n * c_out * h * w_out * w[0].numel()
        return y

    def linear(self, x, w, b):
        rows = math.prod(x.shape[:-1])
        self.flops += 2 * rows * w.shape[0] * w.shape[1]
        return super().linear(x, w, b)

    def matmul(self, a, b):
        y = super().matmul(a, b)
        self.flops += 2 * y.numel() * a.shape[-1]
        return y


def _meta_state_dict(table):
    return {key: torch.empty(shape, device="meta",
                             dtype=torch.int64 if init[0] == "zero_int"
                             else torch.float32)
            for key, shape, init in table}


@functools.lru_cache(maxsize=None)
def model_flops(family, height, width):
    """Operations of one image of (height, width) through ``family``."""
    binding = families.binding(family)
    ops = _Counting()
    x = torch.empty((1, 3, height, width), device="meta")
    binding.forward(_meta_state_dict(binding.specs()), x, ops)
    return ops.flops


def frame_flops(fams, height, width, cfg):
    """{family: operations} of one (height, width) frame under the
    pipeline settings ``cfg``, for ``fams`` ({role: Family}): each family
    at its binding's input, a detector's or a pose model's resize of the
    frame, and a recognizer's one face crop (a frame's recognition work
    is this times the faces embedded)."""
    return {f.name: model_flops(f.name, *f.binding.input_size(height, width,
                                                              cfg))
            for f in fams.values()}
