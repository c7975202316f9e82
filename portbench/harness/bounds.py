"""Least times of the two hand-written kernels on their inputs, and the
H100's published peaks they are measured against (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W).

``kernel_bound_ms``, ``nms_tests`` and ``nms_bound_ms`` are copies of the
repository's chip smoke script's bound arithmetic, kept here so that the
yardstick cannot change with the program."""

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# float32 operations of one IoU test in the NMS mask kernel: 2 max, 2 min,
# 2 subtractions, 2 clamps, 1 product, 2 additions/subtractions, 1
# division, 1 compare.
IOU_OPS = 13


def kernel_bound_ms(m, h, w, k, factor=8):
    """Least time for the fused peak scan of m planes of h x w: each input
    read once and each output written once over HBM, or the FIR and
    comparison operations over the float32 rate, whichever is larger."""
    up_h, up_w = h * factor, w * factor
    # H FIR per (upsampled row, source column), W FIR per upsampled pixel:
    # 4 multiplies + 3 adds each; 4 neighbour compares + threshold.
    ops = m * (up_h * w * 7 + up_h * up_w * (7 + 5))
    nbytes = m * h * w * 4 + m * k * (2 * 4 + 4 + 1) + m
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _iou(a, b):
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def nms_tests(top_boxes, valid, keep, iou_threshold):
    """(N,) IoU tests that greedy NMS needs on these inputs: each kept
    candidate i against each later valid j that no survivor before i has
    suppressed. A valid j is tested by every survivor up to the first one
    that overlaps it, or by every survivor before it if none does."""
    n, k = keep.shape
    idx = torch.arange(k, device=keep.device)
    hits = (keep[:, :, None] & (idx[:, None] < idx[None, :])
            & (_iou(top_boxes, top_boxes) > iou_threshold))
    # The last survivor to test j: its first suppressor, else j - 1.
    last = torch.where(hits, idx[None, :, None], k).amin(dim=1)
    last = torch.minimum(last, idx - 1)
    # kept_upto[:, m + 1] = survivors at or before m.
    kept_upto = torch.nn.functional.pad(keep.long().cumsum(dim=1), (1, 0))
    return (kept_upto.gather(1, last + 1) * valid).sum(dim=1)


def nms_bound_ms(top_boxes, valid, keep, iou_threshold):
    """Least time of the suppression on these inputs, the larger of: boxes
    (16 bytes) and valid flags (1) read once and the keep mask (1) written
    once over HBM; the areas and the IoU tests of :func:`nms_tests` over
    the float32 rate. Returns (ms, "bytes" or "operations")."""
    n, k = keep.shape
    tests = float(nms_tests(top_boxes, valid, keep, iou_threshold).sum())
    ops = tests * IOU_OPS + 3 * n * k
    nbytes = n * k * (16 + 1 + 1)
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def int_mm_bound_s(m, k, n):
    """Least time of an (m, k) x (k, n) int8 product into int32: 2 m k n
    operations at the int8 rate, or both operands read and the result
    written once over HBM, whichever is larger."""
    return max(2.0 * m * k * n / PEAK_INT8_OPS,
               (m * k + k * n + 4 * m * n) / PEAK_BYTES)
