"""Bilinear uint8 resize with OpenCV INTER_LINEAR geometry, on any device.

Geometry ``src = (dst + 0.5) * (in / out) - 0.5`` with edge-clamped taps,
float32 weights, rounded half-to-even back to uint8 — the arithmetic of
``terran_tpu/ops/resize.py::resize_bilinear_u8_torch``, here run on the
tensor's own device so raw frames are uploaded once and resized on the
card. cv2 computes in 2^-11 fixed point, so outputs can differ from it by
one count.

The pipeline's 'host' transfer plan resizes on the host instead, uint8
numpy in and out: :func:`resize_bilinear_u8_host` (the same arithmetic on
a CPU tensor, the 'exact' chain) or :func:`resize_bilinear_u8_cv2`
(OpenCV's own fixed point, imported when called).
"""

import numpy as np
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


def resize_bilinear_u8_host(images, out_h, out_w):
    """(N, H, W, C) uint8 numpy -> (N, out_h, out_w, C) uint8 numpy by
    :func:`resize_bilinear_u8` on the CPU: bit for bit
    ``terran_tpu/ops/resize.py::resize_bilinear_u8_torch``."""
    images = torch.from_numpy(np.ascontiguousarray(images))
    return resize_bilinear_u8(images, out_h, out_w).numpy()


def resize_bilinear_u8_cv2(images, out_h, out_w):
    """(N, H, W, C) uint8 numpy -> (N, out_h, out_w, C) uint8 numpy by
    ``cv2.resize`` INTER_LINEAR, the reference's own host resize (a copy
    of ``terran_tpu/ops/resize.py::resize_bilinear_u8_cv2``): 2^-11 fixed
    point, within one count of :func:`resize_bilinear_u8`. Raises
    ``ImportError`` where OpenCV is not installed."""
    import cv2

    images = np.asarray(images)
    n, _, _, c = images.shape
    out = np.empty((n, out_h, out_w, c), np.uint8)
    for i in range(n):
        cv2.resize(images[i], (out_w, out_h), dst=out[i],
                   interpolation=cv2.INTER_LINEAR)
    return out
