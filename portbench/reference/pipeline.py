"""The perception pipeline's arithmetic in plain PyTorch and NumPy, one
stage at a time, for the benchmark's comparison.

Each function states the published semantics it follows. Nothing here
imports the program; the benchmark hands both sides the same frames and
weights, and this module works out again whatever the program derives
from them (resizes, anchors, decoded boxes, alignment matrices, crops,
upsampled heatmaps).
"""

import numpy as np
import torch
import torch.nn.functional as F

from reference.models import (
    FLOAT, arcface_forward, openpose_forward, retinaface_forward,
)

# RetinaFace's anchors for the mobilenet-0.25 backbone (retinaface/
# wrapper.py): strides 32, 16, 8, two square anchors a cell.
STRIDES = (32, 16, 8)
ANCHOR_SCALES = {32: (32, 16), 16: (8, 4), 8: (2, 1)}
ANCHOR_BASE = 16
ANCHORS_PER_CELL = 2
# ArcFace's 112x112 alignment template (arcface/wrapper.py), x + 8.
TEMPLATE = np.array([[38.2946, 51.6963], [73.5318, 51.5014],
                     [56.0252, 71.7366], [41.5493, 92.3655],
                     [70.7299, 92.2041]], dtype=np.float64)
CROP = 112
PARTS = 18


def resized_shape(h, w, short_side):
    """(out_h, out_w, scale) of a resize to ``short_side``, the sizes
    truncated as the task APIs truncate them."""
    scale = short_side / min(h, w)
    return int(h * scale), int(w * scale), scale


def resize_u8(frames, out_h, out_w):
    """(N, H, W, 3) uint8 -> (N, out_h, out_w, 3) uint8: OpenCV's
    INTER_LINEAR geometry (half-pixel centres, edge-clamped taps) in
    float32, rounded half to even."""
    if tuple(frames.shape[1:3]) == (out_h, out_w):
        return frames
    x = F.interpolate(frames.permute(0, 3, 1, 2).float(), size=(out_h, out_w),
                      mode="bilinear", align_corners=False)
    return torch.round(x).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def anchors(height, width):
    """(A, 4) float32 anchors (x1, y1, x2, y2) for a (height, width)
    input, in the order of the heads' outputs: stride 32, 16, 8; cells
    row-major; the two scales of a cell."""
    planes = []
    for stride in STRIDES:
        fh, fw = -(-height // stride), -(-width // stride)
        ctr = (ANCHOR_BASE - 1) / 2.0
        ref = np.array([[ctr - 0.5 * (ANCHOR_BASE * s - 1)] * 2
                        + [ctr + 0.5 * (ANCHOR_BASE * s - 1)] * 2
                        for s in ANCHOR_SCALES[stride]], np.float32)
        sy, sx = np.meshgrid(np.arange(fh) * stride, np.arange(fw) * stride,
                             indexing="ij")
        shifts = np.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
        planes.append((ref[None] + shifts.astype(np.float32)).reshape(-1, 4))
    return np.concatenate(planes)


def detect(sd, frames, short_side, ops=FLOAT):
    """RetinaFace on (N, H, W, 3) uint8 RGB frames resized to
    ``short_side``: (scores (N, A), boxes (N, A, 4), landmarks (N, A, 5,
    2)) float32 at the detection size, decoded as retinaface/wrapper.py
    decodes (box widths with the +1 of the published code)."""
    n, h, w, _ = frames.shape
    dh, dw, _ = resized_shape(h, w, short_side)
    x = resize_u8(frames, dh, dw).flip(-1).permute(0, 3, 1, 2).float()
    outs = retinaface_forward(sd, x, ops)
    scores, deltas, lmks = [], [], []
    for i in range(0, 9, 3):
        cls, box, lmk = outs[i:i + 3]
        a = ANCHORS_PER_CELL
        scores.append(cls[:, a:].permute(0, 2, 3, 1).reshape(n, -1))
        deltas.append(box.permute(0, 2, 3, 1).reshape(n, -1, 4))
        lmks.append(lmk.permute(0, 2, 3, 1).reshape(n, -1, 5, 2))
    scores, deltas, lmks = (torch.cat(v, 1) for v in (scores, deltas, lmks))
    anc = torch.from_numpy(anchors(dh, dw)).to(frames.device)
    widths = anc[:, 2] - anc[:, 0] + 1.0
    heights = anc[:, 3] - anc[:, 1] + 1.0
    ctr_x = anc[:, 0] + 0.5 * (widths - 1.0)
    ctr_y = anc[:, 1] + 0.5 * (heights - 1.0)
    px = deltas[..., 0] * widths + ctr_x
    py = deltas[..., 1] * heights + ctr_y
    pw = torch.exp(deltas[..., 2]) * widths
    ph = torch.exp(deltas[..., 3]) * heights
    boxes = torch.stack([px - 0.5 * (pw - 1.0), py - 0.5 * (ph - 1.0),
                         px + 0.5 * (pw - 1.0), py + 0.5 * (ph - 1.0)], -1)
    lmk = torch.stack([lmks[..., 0] * widths[:, None] + ctr_x[:, None],
                       lmks[..., 1] * heights[:, None] + ctr_y[:, None]], -1)
    return scores, boxes, lmk


def iou(a, b):
    """Pairwise IoU of (..., A, 4) and (..., B, 4) corner boxes, 0 where
    the union is not positive."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def greedy_nms(boxes, valid, threshold):
    """Keep mask of greedy suppression over (K, 4) boxes in their given
    order (torchvision's rule: a kept box suppresses every later box whose
    IoU with it exceeds ``threshold``)."""
    ious = iou(boxes, boxes).cpu().numpy()
    valid = valid.cpu().numpy()
    keep = np.zeros(len(valid), bool)
    suppressed = np.zeros(len(valid), bool)
    for i in range(len(valid)):
        if valid[i] and not suppressed[i]:
            keep[i] = True
            suppressed[i + 1:] |= ious[i, i + 1:] > threshold
    return keep


def alignment_matrices(landmarks):
    """(M, 5, 2) landmarks -> (M, 2, 3) float32 output-to-input matrices:
    the least-squares similarity from the landmarks to the template
    (Umeyama 1991, as skimage estimates it) in float64, inverted in
    float32, as arcface/wrapper.py hands PIL the inverse."""
    src = np.asarray(landmarks, np.float64)
    m, n, d = src.shape
    mu_src, mu_dst = src.mean(1), TEMPLATE.mean(0)
    src_c, dst_c = src - mu_src[:, None], TEMPLATE - mu_dst
    cov = np.einsum("ki,mkj->mij", dst_c, src_c) / n
    u, s, vt = np.linalg.svd(cov)
    sign = np.ones((m, d))
    neg = np.linalg.det(cov) < 0
    sign[neg, -1] = -1
    tol = s[:, 0] * d * np.finfo(np.float64).eps
    rank = (s > tol[:, None]).sum(1)
    flip = (rank == d - 1) & (np.linalg.det(u) * np.linalg.det(vt) < 0)
    sign[flip & ~neg, -1] = -1
    rot = u * sign[:, None, :] @ vt
    var = (src_c ** 2).sum((1, 2)) / n
    scale = np.where(var > 0, (s * sign).sum(1) / np.where(var > 0, var, 1),
                     1.0)
    fwd = np.zeros((m, 3, 3))
    fwd[:, :d, :d] = scale[:, None, None] * rot
    fwd[:, :d, d] = mu_dst - np.einsum("mij,mj->mi",
                                       scale[:, None, None] * rot, mu_src)
    fwd[:, d, d] = 1.0
    return np.linalg.inv(fwd.astype(np.float32))[:, :2].astype(np.float32)


def warp(frame, matrices):
    """Crops of one (H, W, 3) uint8 frame by (M, 2, 3) output-to-input
    matrices -> (M, 112, 112, 3) float32, whole values: PIL's BILINEAR
    affine transform (the matrix at output pixel centres, pixels whose
    source lies outside [0, W) x [0, H) filled with 0, taps clamped to the
    frame), rounded half to even as the published code stores uint8."""
    h, w, _ = frame.shape
    m = torch.as_tensor(matrices, dtype=torch.float32, device=frame.device)
    grid = torch.arange(CROP, dtype=torch.float32, device=frame.device) + 0.5
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")
    sx = (m[:, 0, 0, None, None] * xx + m[:, 0, 1, None, None] * yy
          + m[:, 0, 2, None, None])
    sy = (m[:, 1, 0, None, None] * xx + m[:, 1, 1, None, None] * yy
          + m[:, 1, 2, None, None])
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    x0, y0 = torch.floor(sx - 0.5), torch.floor(sy - 0.5)
    fx, fy = (sx - 0.5 - x0)[..., None], (sy - 0.5 - y0)[..., None]
    img = frame.float()

    def tap(dy, dx):
        yi = (y0 + dy).clamp(0, h - 1).long()
        xi = (x0 + dx).clamp(0, w - 1).long()
        return img[yi, xi]

    top = tap(0, 0) * (1 - fx) + tap(0, 1) * fx
    bottom = tap(1, 0) * (1 - fx) + tap(1, 1) * fx
    out = top * (1 - fy) + bottom * fy
    return torch.round(torch.where(inside[..., None], out, 0.0))


def embed(sd, frame, landmarks, ops=FLOAT):
    """(M, 512) unit embeddings of the faces of one uint8 frame at the
    given (M, 5, 2) full-resolution landmarks: align, warp, FaceResNet100
    on BGR crops, L2 normalisation."""
    crops = warp(frame, alignment_matrices(landmarks))
    feats = arcface_forward(sd, crops.flip(-1).permute(0, 3, 1, 2), ops)
    return F.normalize(feats, dim=-1, eps=1e-12)


def heatmaps(sd, frames, short_side, ops=FLOAT):
    """OpenPose's 18 part heatmaps of (N, H, W, 3) uint8 RGB frames
    resized to ``short_side``, upsampled x8 by the published code's
    ``F.interpolate(mode='bicubic', align_corners=False)``: (N, 18, 8h,
    8w) float32."""
    _, h, w, _ = frames.shape
    ph, pw, _ = resized_shape(h, w, short_side)
    x = resize_u8(frames, ph, pw).permute(0, 3, 1, 2).float() / 255.0 - 0.5
    _, heat = openpose_forward(sd, x, ops)
    return F.interpolate(heat[:, :PARTS], scale_factor=8, mode="bicubic",
                         align_corners=False)


def local_maxima(heat, threshold):
    """(..., H, W) bool: interior pixels at least their four neighbours
    and the threshold (openpose/wrapper.py's peak test)."""
    mid = heat[..., 1:-1, 1:-1]
    peaks = torch.zeros_like(heat, dtype=torch.bool)
    peaks[..., 1:-1, 1:-1] = ((mid >= heat[..., :-2, 1:-1])
                              & (mid >= heat[..., 2:, 1:-1])
                              & (mid >= heat[..., 1:-1, :-2])
                              & (mid >= heat[..., 1:-1, 2:])
                              & (mid >= threshold))
    return peaks
