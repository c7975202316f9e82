"""OpenPose's BODY_25 body model in PyTorch.

The network of OpenPose's ``models/pose/body_25/pose_deploy.prototxt``
(Cao, Hidalgo, Simon, Wei, Sheikh, TPAMI 2019, arXiv:1812.08008), its
default model since v1.3: 25 parts (feet and a mid-hip beside COCO's 18)
and 26 limbs.

- A VGG-19 trunk to ``conv4_2`` (3x3 convolutions, ReLU, three 2x2 max
  pools), then ``conv4_2``, ``conv4_3_CPM`` (256) and ``conv4_4_CPM``
  (128) each with a per-channel PReLU; its output is F.
- A dense block of width w: three chained 3x3 convolutions with PReLU,
  ``Mconv{b}_stage{s}_L{l}_{0,1,2}``, whose three outputs are
  concatenated (3w channels).
- A stage: five dense blocks, ``Mconv6`` 1x1 with PReLU to m channels,
  ``Mconv7`` 1x1 linear.
- Four PAF stages (``L2``, 52 channels) first: stage 0 on F, stages 1-3 on
  ``concat(F, PAF)``; then two heatmap stages (``L1``, 26 channels, the
  background last): stage 0 on ``concat(F, PAF_3)``, stage 1 on
  ``concat(F, H_0, PAF_3)``.
- Output ``concat(H_1, PAF_3)``, 78 channels, the heatmaps first, at an
  eighth of the input, returned as the (pafs, heatmaps) pair that
  ``models/openpose.py`` returns: two views of the one joined tensor, so
  that nothing is copied.

The published network takes BGR as ``x / 256 - 0.5``; its converter
(``utils/convert.py::convert_body25``) flips the first conv's input
channels, so this module takes RGB ``x / 256 - 0.5``
(:attr:`Body25Model.input_scale`). Inputs and outputs are NHWC like
``models/openpose.py``'s; the convolutions run NCHW (cuDNN on the card).
Layer names are the prototxt's, so the state dict's keys are
``<layer>.weight`` and ``<layer>.bias``, and a PReLU's slopes
``<prelu layer>.weight``. The widths are constructor arguments whose
defaults are the published ones (:meth:`Body25Model.from_state_dict` reads
them from the weights).
"""

import torch
from torch import nn

from terran_tpu_torch.models.layers import biased_conv, max_pool_2x2

HEAT_CHANNELS = 26  # 25 parts and the background
PAF_CHANNELS = 52
# The trunk's convolutions in forward order and their published widths;
# a 2x2 max pool follows conv1_2, conv2_2 and conv3_4.
TRUNK_LAYERS = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1",
                "conv3_2", "conv3_3", "conv3_4", "conv4_1", "conv4_2",
                "conv4_3_CPM", "conv4_4_CPM")
TRUNK_WIDTHS = (64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 256, 128)
_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_4"}
_TRUNK_PRELU = {"conv4_2": "prelu4_2", "conv4_3_CPM": "prelu4_3_CPM",
                "conv4_4_CPM": "prelu4_4_CPM"}
# (branch, stage) in forward order and each stage's published (dense
# width w, Mconv6 width m).
STAGES = (("L2", 0), ("L2", 1), ("L2", 2), ("L2", 3), ("L1", 0), ("L1", 1))
STAGE_WIDTHS = ((96, 256), (128, 512), (128, 512), (128, 512), (96, 256),
                (128, 512))
BLOCKS = 5


def layers():
    """(conv name, activation) of every convolution in forward order: the
    activation 'relu', the name of the conv's PReLU, or None."""
    out = [(name, _TRUNK_PRELU.get(name, "relu")) for name in TRUNK_LAYERS]
    for branch, s in STAGES:
        out += [(f"Mconv{b}_stage{s}_{branch}_{j}",
                 f"Mprelu{b}_stage{s}_{branch}_{j}")
                for b in range(1, BLOCKS + 1) for j in range(3)]
        out += [(f"Mconv6_stage{s}_{branch}", f"Mprelu6_stage{s}_{branch}"),
                (f"Mconv7_stage{s}_{branch}", None)]
    return out


def _stage_inputs(feature, branch, stage):
    if branch == "L2":
        return feature + (PAF_CHANNELS if stage else 0)
    return feature + PAF_CHANNELS + (HEAT_CHANNELS if stage else 0)


class Body25Model(nn.Module):
    """(N, H, W, 3) RGB ``x / 256 - 0.5`` -> (pafs, heatmaps), NHWC views
    of the (N, H/8, W/8, 78) output: its last 52 channels and its first
    26 (25 parts and the background)."""

    input_scale = 256.0

    def __init__(self, trunk_widths=TRUNK_WIDTHS, stage_widths=STAGE_WIDTHS):
        super().__init__()
        # (in, out, kernel) of each conv, in layers()' order.
        shapes, c = [], 3
        for width in trunk_widths:
            shapes.append((c, width, 3))
            c = width
        feature = c
        for (branch, s), (w, m) in zip(STAGES, stage_widths):
            c = _stage_inputs(feature, branch, s)
            for _ in range(BLOCKS):
                shapes += [(c, w, 3), (w, w, 3), (w, w, 3)]
                c = 3 * w
            shapes += [(c, m, 1), (m, PAF_CHANNELS if branch == "L2"
                                   else HEAT_CHANNELS, 1)]
        self._acts = dict(layers())
        for (name, act), (cin, cout, k) in zip(layers(), shapes):
            # A 'same' conv with bias, then its activation.
            self.add_module(name, nn.Conv2d(cin, cout, k, padding=k // 2))
            if act not in (None, "relu"):
                self.add_module(act, nn.PReLU(cout))

    @classmethod
    def from_state_dict(cls, state_dict, dtype=torch.float32):
        """The model at the widths of ``state_dict``'s weights, in
        ``dtype``; the weights are not loaded."""
        trunk = tuple(state_dict[f"{name}.weight"].shape[0]
                      for name in TRUNK_LAYERS)
        stages = tuple(
            (state_dict[f"Mconv1_stage{s}_{branch}_0.weight"].shape[0],
             state_dict[f"Mconv6_stage{s}_{branch}.weight"].shape[0])
            for branch, s in STAGES)
        return cls(trunk, stages).to(dtype=dtype)

    @property
    def compute_dtype(self):
        return self.conv1_1.weight.dtype

    def _conv(self, name, x):
        """The conv ``name`` and its bias and activation in one epilogue
        (``layers.biased_conv``)."""
        act = self._acts[name]
        alpha = None if act in (None, "relu") else getattr(self, act).weight
        return biased_conv(getattr(self, name), x, relu=act == "relu",
                           alpha=alpha)

    def _stage(self, x, branch, s):
        for b in range(1, BLOCKS + 1):
            outs = []
            for j in range(3):
                x = self._conv(f"Mconv{b}_stage{s}_{branch}_{j}", x)
                outs.append(x)
            x = torch.cat(outs, dim=1)
        x = self._conv(f"Mconv6_stage{s}_{branch}", x)
        return self._conv(f"Mconv7_stage{s}_{branch}", x)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for name in TRUNK_LAYERS:
            h = self._conv(name, h)
            if name in _POOL_AFTER:
                h = max_pool_2x2(h)
        feature = h
        paf = self._stage(feature, "L2", 0)
        for s in (1, 2, 3):
            paf = self._stage(torch.cat([feature, paf], dim=1), "L2", s)
        heat = self._stage(torch.cat([feature, paf], dim=1), "L1", 0)
        heat = self._stage(torch.cat([feature, heat, paf], dim=1), "L1", 1)
        out = torch.cat([heat, paf], dim=1).permute(0, 2, 3, 1)
        return out[..., HEAT_CHANNELS:], out[..., :HEAT_CHANNELS]
