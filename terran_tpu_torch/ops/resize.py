"""Bilinear uint8 resize with OpenCV INTER_LINEAR geometry, on any device.

Geometry ``src = (dst + 0.5) * (in / out) - 0.5`` with edge-clamped taps,
float32 weights, rounded half-to-even back to uint8 — the arithmetic of
``terran_tpu/ops/resize.py::resize_bilinear_u8_torch``, here run on the
tensor's own device so raw frames are uploaded once and resized on the
card. cv2 computes in 2^-11 fixed point, so outputs can differ from it by
one count.
"""

import torch
import torch.nn.functional as F


def resized_shape(h, w, short_side):
    """The (out_h, out_w, scale) the task APIs' resize produces
    (utils/batching.py resize_factory)."""
    scale = short_side / min(h, w)
    return int(h * scale), int(w * scale), scale


def resize_bilinear_u8(images, out_h, out_w):
    """(N, H, W, C) uint8 tensor -> (N, out_h, out_w, C) uint8 tensor on
    the same device."""
    if images.dtype != torch.uint8 or images.dim() != 4:
        raise ValueError("expected an (N, H, W, C) uint8 tensor, got "
                         f"{tuple(images.shape)} {images.dtype}")
    if tuple(images.shape[1:3]) == (out_h, out_w):
        return images
    x = images.permute(0, 3, 1, 2).to(torch.float32)
    out = F.interpolate(
        x, size=(out_h, out_w), mode="bilinear", align_corners=False
    )
    out = torch.round(out).clamp_(0, 255).to(torch.uint8)
    return out.permute(0, 2, 3, 1).contiguous()
