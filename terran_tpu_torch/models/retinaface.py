"""RetinaFace (pseudo-MobileNet-0.25 backbone) in PyTorch.

The port of ``terran_tpu/models/retinaface.py``, which re-implements the
reference network (retinaface/model.py) and its anchors
(retinaface/anchors.py), with the decode and a fixed-K masked NMS on the
device instead of the reference's per-image Python loop.

Inputs and head outputs are NHWC like the JAX model's; the convolutions
run NCHW (cuDNN on the card). Module names are the JAX model's, so the
state dict keys follow its parameter paths (``utils/convert.py``). The
converter folds BatchNorm into (scale, bias) and the RGB->BGR flip into
the first conv, so the model takes RGB pixels in [0, 255].
"""

import functools

import numpy as np
import torch
from torch import nn

from terran_tpu_torch.models.layers import (
    ConvAffine, biased_conv, upsample2x_nearest,
)
from terran_tpu_torch.ops.nms import nms_fixed

# Anchor configuration of the `mnet` backbone (retinaface/wrapper.py:100-117).
FEATURE_STRIDES = (32, 16, 8)
ANCHOR_SCALES = {32: (32, 16), 16: (8, 4), 8: (2, 1)}
ANCHOR_BASE_SIZE = 16
NUM_ANCHORS = 2


class ConvSepBlock(nn.Module):
    """1x1 conv-BN-ReLU, then a depthwise 3x3 conv-BN-ReLU (model.py:6-50).
    With ``return_both`` the 1x1 output is also a pyramid tap."""

    def __init__(self, in_channels, features, stride=1, return_both=False):
        super().__init__()
        self.conv_block = ConvAffine(in_channels, features, 1, 1, 0)
        self.sep_block = ConvAffine(features, features, 3, stride, 1,
                                    groups=features)
        self.return_both = return_both

    def forward(self, x):
        conv = self.conv_block(x)
        sep = self.sep_block(conv)
        return (conv, sep) if self.return_both else sep


# (name, in, out, stride) of the backbone's separable blocks; s0_b4 and
# s1_b5 also emit the stride-8 and stride-16 taps.
_SEP_BLOCKS = (
    ("s0_b0", 8, 16, 2), ("s0_b1", 16, 32, 1), ("s0_b2", 32, 32, 2),
    ("s0_b3", 32, 64, 1), ("s0_b4", 64, 64, 2),
    ("s1_b0", 64, 128, 1), ("s1_b1", 128, 128, 1), ("s1_b2", 128, 128, 1),
    ("s1_b3", 128, 128, 1), ("s1_b4", 128, 128, 1), ("s1_b5", 128, 128, 2),
    ("final_b0", 128, 256, 1),
)
_TAPS = ("s0_b4", "s1_b5")


class BaseNetwork(nn.Module):
    """Pseudo-MobileNet(0.25) emitting stride-8/16/32 features
    (model.py:53-112)."""

    def __init__(self):
        super().__init__()
        self.first_conv = ConvAffine(3, 8, 3, 2, 1)
        self.first_sep = ConvAffine(8, 8, 3, 1, 1, groups=8)
        for name, cin, cout, stride in _SEP_BLOCKS:
            self.add_module(name, ConvSepBlock(cin, cout, stride,
                                               return_both=name in _TAPS))
        self.final_conv = ConvAffine(256, 256, 1, 1, 0)

    def forward(self, x):
        x = self.first_sep(self.first_conv(x))
        taps = []
        for name, *_ in _SEP_BLOCKS:
            x = getattr(self, name)(x)
            if name in _TAPS:
                tap, x = x
                taps.append(tap)
        return taps[0], taps[1], self.final_conv(x)


class ContextModule(nn.Module):
    """3x3/5x5/7x7 receptive-field mixer (model.py:115-165)."""

    def __init__(self):
        super().__init__()
        self.ctx3 = ConvAffine(64, 32, 3, 1, 1)
        self.reducer = ConvAffine(64, 16, 3, 1, 1)
        self.ctx5 = ConvAffine(16, 16, 3, 1, 1)
        self.ctx7a = ConvAffine(16, 16, 3, 1, 1)
        self.ctx7b = ConvAffine(16, 16, 3, 1, 1)

    def forward(self, x):
        red = self.reducer(x)
        return torch.cat(
            [self.ctx3(x), self.ctx5(red), self.ctx7b(self.ctx7a(red))], dim=1
        )


class PyramidRefiner(nn.Module):
    """FPN top-down refinement + context modules (model.py:168-245)."""

    def __init__(self):
        super().__init__()
        self.conv_s8 = ConvAffine(64, 64, 1, 1, 0)
        self.conv_s16 = ConvAffine(128, 64, 1, 1, 0)
        self.conv_s32 = ConvAffine(256, 64, 1, 1, 0)
        self.aggr_s16 = ConvAffine(64, 64, 3, 1, 1)
        self.aggr_s8 = ConvAffine(64, 64, 3, 1, 1)
        self.ctx_s8 = ContextModule()
        self.ctx_s16 = ContextModule()
        self.ctx_s32 = ContextModule()

    def forward(self, feats):
        f8, f16, f32 = feats
        p8, p16, p32 = self.conv_s8(f8), self.conv_s16(f16), self.conv_s32(f32)
        p16 = self.aggr_s16(p16 + upsample2x_nearest(p32, *p16.shape[2:]))
        p8 = self.aggr_s8(p8 + upsample2x_nearest(p16, *p8.shape[2:]))
        return self.ctx_s8(p8), self.ctx_s16(p16), self.ctx_s32(p32)


class Heads(nn.Module):
    """Per-stride 1x1 heads: cls (2A), bbox (4A), landmarks (10A); the
    softmax is left to the decode (model.py:248-316)."""

    def __init__(self):
        super().__init__()
        for stride in (8, 16, 32):
            for head, ch in (("cls", 2), ("bbox", 4), ("landmark", 10)):
                self.add_module(f"{head}_s{stride}",
                                nn.Conv2d(64, ch * NUM_ANCHORS, 1))

    def forward(self, feats):
        outs = {}
        for stride, feat in zip((8, 16, 32), feats):
            outs[stride] = tuple(
                biased_conv(getattr(self, f"{head}_s{stride}"),
                            feat).permute(0, 2, 3, 1)
                for head in ("cls", "bbox", "landmark")
            )
        return outs


class RetinaFace(nn.Module):
    """(N, H, W, 3) RGB -> {stride: (cls, box, lmk)} NHWC head outputs
    (model.py:319-341)."""

    def __init__(self):
        super().__init__()
        self.base = BaseNetwork()
        self.refiner = PyramidRefiner()
        self.heads = Heads()

    @classmethod
    def from_state_dict(cls, state_dict, dtype=torch.float32):
        """The model in ``dtype``; the weights are not loaded."""
        return cls().to(dtype=dtype)

    @property
    def compute_dtype(self):
        return self.base.first_conv.conv.weight.dtype

    def forward(self, x):
        feats = self.base(x.permute(0, 3, 1, 2))
        return self.heads(self.refiner(feats))


# ---------------------------------------------------------------------------
# Anchors (numpy, copied from terran_tpu/models/retinaface.py)
# ---------------------------------------------------------------------------

def anchor_reference(stride):
    """(A, 4) anchor template for a stride, centred on the first cell:
    with ratio 1 the template for scale ``s`` is a square of side
    ``16 * s`` centred at (7.5, 7.5) (anchors.py:75-134)."""
    anchors = []
    for s in ANCHOR_SCALES[stride]:
        side = ANCHOR_BASE_SIZE * s
        ctr = (ANCHOR_BASE_SIZE - 1) / 2.0
        anchors.append(
            [ctr - 0.5 * (side - 1), ctr - 0.5 * (side - 1),
             ctr + 0.5 * (side - 1), ctr + 0.5 * (side - 1)]
        )
    return np.array(anchors, dtype=np.float32)


@functools.lru_cache(maxsize=256)
def anchors_for_shape(height, width):
    """All anchors for an input of (height, width), concatenated over
    strides 32, 16, 8 in the reference's order (wrapper.py:169,200-202):
    an (A_total, 4) float32 array in (x1, y1, x2, y2) image coords."""
    planes = []
    for stride in FEATURE_STRIDES:
        fh = -(-height // stride)
        fw = -(-width // stride)
        ref = anchor_reference(stride)
        shift_x = (np.arange(fw) * stride).astype(np.float32)
        shift_y = (np.arange(fh) * stride).astype(np.float32)
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        planes.append((ref[None, :, :] + shifts).reshape(-1, 4))
    return np.concatenate(planes, axis=0)


def anchor_cell_meta(height, width):
    """Per-anchor feature-map cell (cell_x, cell_y, cell_stride) int32
    arrays, in the anchor order of :func:`anchors_for_shape`."""
    cell_x, cell_y, cell_stride = [], [], []
    for stride in FEATURE_STRIDES:
        fh = -(-height // stride)
        fw = -(-width // stride)
        ys, xs = np.meshgrid(np.arange(fh), np.arange(fw), indexing="ij")
        for arr, vals in ((cell_x, xs), (cell_y, ys)):
            arr.append(np.repeat(vals.reshape(-1), NUM_ANCHORS))
        cell_stride.append(np.full(fh * fw * NUM_ANCHORS, stride))
    return (
        np.concatenate(cell_x).astype(np.int32),
        np.concatenate(cell_y).astype(np.int32),
        np.concatenate(cell_stride).astype(np.int32),
    )


def decode_outputs(outputs, anchors):
    """Decode raw head outputs into (scores (N, A), boxes (N, A, 4),
    landmarks (N, A, 5, 2)), float32, as decode_bboxes/decode_landmarks
    (wrapper.py:25-89) do, with the +1 box widths of the reference.

    ``outputs``: {stride: (cls, box, lmk)} NHWC; ``anchors``: (A, 4)
    float32 tensor on the outputs' device.
    """
    scores_l, boxes_l, lmks_l = [], [], []
    for stride in FEATURE_STRIDES:
        cls, box, lmk = outputs[stride]
        n = cls.shape[0]
        cls = cls.to(torch.float32)
        # Channels are [bg_a0, bg_a1, face_a0, face_a1]; the two-way
        # softmax per anchor is sigmoid(face - bg).
        face = torch.sigmoid(cls[..., NUM_ANCHORS:] - cls[..., :NUM_ANCHORS])
        scores_l.append(face.reshape(n, -1))
        boxes_l.append(box.to(torch.float32).reshape(n, -1, 4))
        lmks_l.append(lmk.to(torch.float32).reshape(n, -1, 5, 2))

    scores = torch.cat(scores_l, dim=1)
    deltas = torch.cat(boxes_l, dim=1)
    lmk_deltas = torch.cat(lmks_l, dim=1)

    widths = anchors[:, 2] - anchors[:, 0] + 1.0
    heights = anchors[:, 3] - anchors[:, 1] + 1.0
    ctr_x = anchors[:, 0] + 0.5 * (widths - 1.0)
    ctr_y = anchors[:, 1] + 0.5 * (heights - 1.0)

    pred_ctr_x = deltas[..., 0] * widths + ctr_x
    pred_ctr_y = deltas[..., 1] * heights + ctr_y
    pred_w = torch.exp(deltas[..., 2]) * widths
    pred_h = torch.exp(deltas[..., 3]) * heights
    boxes = torch.stack(
        [
            pred_ctr_x - 0.5 * (pred_w - 1.0),
            pred_ctr_y - 0.5 * (pred_h - 1.0),
            pred_ctr_x + 0.5 * (pred_w - 1.0),
            pred_ctr_y + 0.5 * (pred_h - 1.0),
        ],
        dim=-1,
    )
    landmarks = torch.stack(
        [
            lmk_deltas[..., 0] * widths[None, :, None] + ctr_x[None, :, None],
            lmk_deltas[..., 1] * heights[None, :, None] + ctr_y[None, :, None],
        ],
        dim=-1,
    )
    return scores, boxes, landmarks


def make_detect_fn(model, height, width, *, nms_threshold=0.4, top_k=256):
    """The detection step for a fixed (height, width) input.

    The returned ``detect(images, threshold=0.5, valid_w=width,
    valid_h=height)`` maps an (N, height, width, 3) uint8 tensor on the
    model's device to the packed (N, top_k, 17) float32 result (see
    :func:`unpack_detections`): forward, decode, the valid-cell mask and
    NMS, all on that device, so one copy returns everything.

    ``valid_w``/``valid_h`` mask out anchors whose feature-map cell lies
    beyond the valid region (the 'pad' bucketing): a cell is valid iff its
    index is below ceil(valid / stride), the cells the reference evaluates
    for the unpadded size. The test is on cells, not anchor centres, as in
    ``terran_tpu/models/retinaface.py::make_detect_fn``.
    """
    device = next(model.parameters()).device
    anchors = torch.from_numpy(anchors_for_shape(height, width)).to(device)
    cell_x, cell_y, cell_stride = (
        torch.from_numpy(a).to(device) for a in anchor_cell_meta(height, width)
    )

    @torch.inference_mode()
    def detect(images, threshold=0.5, valid_w=width, valid_h=height):
        outputs = model(images.to(model.compute_dtype))
        scores, boxes, landmarks = decode_outputs(outputs, anchors)
        in_bounds = (
            (cell_x < (valid_w + cell_stride - 1) // cell_stride)
            & (cell_y < (valid_h + cell_stride - 1) // cell_stride)
        )
        scores = torch.where(in_bounds[None, :], scores, 0.0)

        kept_boxes, kept_scores, keep, order, overflow = nms_fixed(
            boxes, scores, nms_threshold, score_threshold=threshold,
            top_k=top_k,
        )
        n = scores.shape[0]
        kept_landmarks = landmarks.reshape(n, -1, 10).gather(
            1, order[..., None].expand(n, top_k, 10)
        )
        return torch.cat(
            [
                kept_boxes,
                kept_landmarks,
                kept_scores[..., None],
                keep[..., None].to(torch.float32),
                overflow[:, None, None].expand(n, top_k, 1).to(torch.float32),
            ],
            dim=-1,
        )

    return detect


def unpack_detections(packed):
    """Split the packed (N, K, 17) detect output (a numpy array) into
    (boxes (N, K, 4), landmarks (N, K, 5, 2), scores (N, K), mask (N, K)
    bool, overflow (N,) bool). ``overflow`` marks images where more
    candidates cleared the score threshold than the top-K pre-selection
    kept."""
    n, k, _ = packed.shape
    boxes = packed[..., :4]
    landmarks = packed[..., 4:14].reshape(n, k, 5, 2)
    scores = packed[..., 14]
    mask = packed[..., 15] > 0.5
    overflow = packed[..., 0, 16] > 0.5
    return boxes, landmarks, scores, mask, overflow
