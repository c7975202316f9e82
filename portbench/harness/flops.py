"""Operations of the three models' convolutions and dense layers, counted
from their shapes: 2 x (multiply-adds) of each, as
``torch.utils.flop_counter`` counts them. The reference forwards run on
the ``meta`` device with a counting ``ops`` object, so nothing is
computed and the layer list cannot drift from the reference's."""

import functools

import torch

from reference import models
from reference.models import Float
from reference.pipeline import CROP, resized_shape


class _Counting(Float):
    def __init__(self):
        self.flops = 0

    def conv(self, x, w, b, stride=1, pad=0, groups=1):
        y = super().conv(x, w, b, stride, pad, groups)
        n, c_out, h, w_out = y.shape
        self.flops += 2 * n * c_out * h * w_out * w[0].numel()
        return y

    def linear(self, x, w, b):
        self.flops += 2 * x.shape[0] * w.shape[0] * w.shape[1]
        return super().linear(x, w, b)


def _meta_state_dict(family):
    return {key: torch.empty(shape, device="meta",
                             dtype=torch.int64 if init[0] == "zero_int"
                             else torch.float32)
            for key, shape, init in models.specs(family)}


@functools.lru_cache(maxsize=None)
def model_flops(family, height, width):
    """Operations of one image of (height, width) through ``family``."""
    ops = _Counting()
    x = torch.empty((1, 3, height, width), device="meta")
    forward = {"retinaface": models.retinaface_forward,
               "arcface": models.arcface_forward,
               "openpose": models.openpose_forward}[family]
    forward(_meta_state_dict(family), x, ops)
    return ops.flops


def frame_flops(height, width, det_short_side, pose_short_side):
    """{family: operations} of one (height, width) frame: detection at its
    resize, pose at its resize, and one face crop (a frame's recognition
    work is this times the faces embedded)."""
    dh, dw, _ = resized_shape(height, width, det_short_side)
    ph, pw, _ = resized_shape(height, width, pose_short_side)
    return {"retinaface": model_flops("retinaface", dh, dw),
            "openpose": model_flops("openpose", ph, pw),
            "arcface": model_flops("arcface", CROP, CROP)}
