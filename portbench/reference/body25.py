"""OpenPose's BODY_25 body model in plain PyTorch, float32: the network of
``models/pose/body_25/pose_deploy.prototxt`` (Cao, Hidalgo, Simon, Wei,
Sheikh, TPAMI 2019, arXiv:1812.08008; weights ``pose_iter_584000``), on
state dicts in its key format: each Caffe layer's blobs as
``<layer>.weight`` and ``<layer>.bias``, a PReLU's slopes as
``<prelu layer>.weight``.

It imports nothing of the program or its tests. Every convolution goes
through an ``ops`` object (``reference/models.py``), so that the same
forward computes the float32 reference, the control in a lower precision
and the benchmark's operation count.

The network:

- input: BGR, ``x / 256 - 0.5`` (OpenPose's ``uCharCvMatToFloatPtr``,
  normalisation 1);
- trunk: VGG-19's 3x3 convolutions to ``conv4_1`` with ReLU and three
  2x2/2 max pools, then ``conv4_2``, ``conv4_3_CPM`` and ``conv4_4_CPM``
  each with a per-channel PReLU; its output is F, 128 channels;
- a dense block of width w: ``a = PReLU(conv3x3(x))``, ``b =
  PReLU(conv3x3(a))``, ``c = PReLU(conv3x3(b))``, output ``concat(a, b,
  c)``;
- a stage: five dense blocks, ``Mconv6`` 1x1 with PReLU, ``Mconv7`` 1x1
  linear;
- four PAF stages (``L2``, 52 channels): stage 0 on F, stages 1-3 on
  ``concat(F, PAF)``; then two heatmap stages (``L1``, 26 channels: 25
  parts and the background): stage 0 on ``concat(F, PAF_3)``, stage 1 on
  ``concat(F, H_0, PAF_3)``;
- output ``concat(H_1, PAF_3)``, 78 channels, the heatmaps first.
"""

import torch
import torch.nn.functional as F

from reference import pipeline as ref
from reference.models import FLOAT

PARTS = 25
HEAT_CHANNELS = PARTS + 1
PAF_CHANNELS = 52
# The trunk's layers and their published widths; a 2x2 max pool follows
# conv1_2, conv2_2 and conv3_4, and the last three end in a PReLU.
TRUNK = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
         "conv3_3", "conv3_4", "conv4_1", "conv4_2", "conv4_3_CPM",
         "conv4_4_CPM")
TRUNK_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 256, 128)
POOL_AFTER = ("conv1_2", "conv2_2", "conv3_4")
PRELU_TRUNK = {"conv4_2": "prelu4_2", "conv4_3_CPM": "prelu4_3_CPM",
               "conv4_4_CPM": "prelu4_4_CPM"}
# (branch, stage) in forward order, and each stage's published dense
# width w and Mconv6 width m.
STAGES = (("L2", 0), ("L2", 1), ("L2", 2), ("L2", 3), ("L1", 0), ("L1", 1))
STAGE_WIDTHS = ((96, 256), (128, 512), (128, 512), (128, 512), (96, 256),
                (128, 512))
BLOCKS = 5


def _stage_outputs(branch):
    return PAF_CHANNELS if branch == "L2" else HEAT_CHANNELS


def _stage_inputs(feature, branch, stage):
    if branch == "L2":
        return feature + (PAF_CHANNELS if stage else 0)
    return feature + PAF_CHANNELS + (HEAT_CHANNELS if stage else 0)


def layers(trunk_widths=TRUNK_WIDTHS, stage_widths=STAGE_WIDTHS):
    """(conv name, in, out, kernel, activation) of every convolution, in
    forward order, at the given widths; the activation is 'relu', the
    name of the conv's PReLU, or None."""
    out, c = [], 3
    for name, width in zip(TRUNK, trunk_widths):
        out.append((name, c, width, 3, PRELU_TRUNK.get(name, "relu")))
        c = width
    feature = c
    for (branch, s), (w, m) in zip(STAGES, stage_widths):
        c = _stage_inputs(feature, branch, s)
        for b in range(1, BLOCKS + 1):
            for j in range(3):
                out.append((f"Mconv{b}_stage{s}_{branch}_{j}",
                            c if j == 0 else w, w, 3,
                            f"Mprelu{b}_stage{s}_{branch}_{j}"))
            c = 3 * w
        out.append((f"Mconv6_stage{s}_{branch}", c, m, 1,
                    f"Mprelu6_stage{s}_{branch}"))
        out.append((f"Mconv7_stage{s}_{branch}", m, _stage_outputs(branch),
                    1, None))
    return out


def body25_specs(trunk_widths=TRUNK_WIDTHS, stage_widths=STAGE_WIDTHS):
    """(key, shape, init) of the published checkpoint's state dict, at the
    given widths (the published ones by default). A convolution's weights
    are drawn N(0, gain^2 / fan-in), with He et al.'s gain for what
    follows it: sqrt(2) before a ReLU, sqrt(2 / (1 + 0.25^2)) before a
    PReLU at Caffe's slope filler 0.25, 1 before none; its biases N(0,
    0.01); a PReLU's slopes |N(0, 0.1)| + 0.15 a channel. The signal
    keeps its scale through the ~110 convolutions of the deepest path, so
    that on noise frames the heatmaps vary by about 0.4 and all but a few
    parts hold local maxima above the pipeline's 0.1 threshold, where
    ``reference/models.py``'s draws (1 / sqrt(fan-in), biases N(0, 0.1))
    leave them flat at their biases."""
    gains = {"relu": 2.0 ** 0.5, None: 1.0}
    s = []
    for name, cin, cout, k, act in layers(trunk_widths, stage_widths):
        gain = gains.get(act, (2.0 / (1.0 + 0.25 ** 2)) ** 0.5)
        s += [(f"{name}.weight", (cout, cin, k, k),
               ("normal", gain / (cin * k * k) ** 0.5)),
              (f"{name}.bias", (cout,), ("normal", 0.01))]
        if act not in (None, "relu"):
            s.append((f"{act}.weight", (cout,), ("abs_plus", 0.1, 0.15)))
    return s


def _check_tf32(x):
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("the float32 reference needs TF32 off")


def body25_forward(sd, x, ops=FLOAT):
    """(N, 3, H, W) float32 BGR as ``x / 256 - 0.5`` -> (N, 78, h, w) at an
    eighth of the input: the 26 heatmaps, then the 52 PAF channels. The
    widths follow ``sd``."""
    _check_tf32(x)

    def conv(h, name, act):
        w = sd[f"{name}.weight"]
        h = ops.conv(h, w, sd[f"{name}.bias"], pad=w.shape[-1] // 2)
        if act == "relu":
            return F.relu(h)
        if act is not None:
            return F.prelu(h, sd[f"{act}.weight"])
        return h

    h = x
    for name in TRUNK:
        h = conv(h, name, PRELU_TRUNK.get(name, "relu"))
        if name in POOL_AFTER:
            h = F.max_pool2d(h, 2, 2)
    feature = h

    def stage(h, branch, s):
        for b in range(1, BLOCKS + 1):
            outs = []
            for j in range(3):
                h = conv(h, f"Mconv{b}_stage{s}_{branch}_{j}",
                         f"Mprelu{b}_stage{s}_{branch}_{j}")
                outs.append(h)
            h = torch.cat(outs, dim=1)
        h = conv(h, f"Mconv6_stage{s}_{branch}", f"Mprelu6_stage{s}_{branch}")
        return conv(h, f"Mconv7_stage{s}_{branch}", None)

    paf = stage(feature, "L2", 0)
    for s in (1, 2, 3):
        paf = stage(torch.cat([feature, paf], dim=1), "L2", s)
    heat = stage(torch.cat([feature, paf], dim=1), "L1", 0)
    heat = stage(torch.cat([feature, heat, paf], dim=1), "L1", 1)
    return torch.cat([heat, paf], dim=1)


def heatmaps(sd, frames, short_side, ops=FLOAT):
    """BODY_25's 25 part heatmaps of (N, H, W, 3) uint8 RGB frames resized
    to ``short_side``, upsampled x8 as ``reference/pipeline.py::heatmaps``
    upsamples OpenPose's (``F.interpolate(mode='bicubic',
    align_corners=False)``): (N, 25, 8h, 8w) float32."""
    _, h, w, _ = frames.shape
    ph, pw, _ = ref.resized_shape(h, w, short_side)
    x = ref.resize_u8(frames, ph, pw).flip(-1).permute(0, 3, 1, 2).float()
    out = body25_forward(sd, x / 256.0 - 0.5, ops)
    return F.interpolate(out[:, :PARTS], scale_factor=8, mode="bicubic",
                         align_corners=False)
