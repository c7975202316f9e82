"""OpenPose (CMU 2017 body model) in PyTorch.

The port of ``terran_tpu/models/openpose.py``, which re-implements the
reference ``BodyPoseModel`` (openpose/model.py:27-141): a VGG-style trunk
(``block0``, model.py:41-57) followed by six refinement stages with two
branches each — L1 predicting 38-channel part-affinity fields and L2
predicting 19-channel keypoint heatmaps — where each stage consumes
``concat(prev_L1, prev_L2, trunk)`` (185 channels, model.py:114-141).

Inputs and outputs are NHWC like the JAX model's; the convolutions run
NCHW (cuDNN on the card). Layer names are the JAX model's, so the state
dict keys are ``<layer>.weight`` / ``<layer>.bias``
(``utils/convert.py``).
"""

import torch
from torch import nn

from terran_tpu_torch.models.layers import ConvBias, max_pool_2x2

PAF_CHANNELS = 38
HEATMAP_CHANNELS = 19
TRUNK_CHANNELS = 128
STAGE_CHANNELS = PAF_CHANNELS + HEATMAP_CHANNELS + TRUNK_CHANNELS  # 185

# (name, in, out); a 2x2 max-pool follows conv1_2, conv2_2 and conv3_4.
_BLOCK0 = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256),
    ("conv3_3", 256, 256), ("conv3_4", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512),
    ("conv4_3_CPM", 512, 256), ("conv4_4_CPM", 256, TRUNK_CHANNELS),
)
_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_4"}


def _stage1_names(branch):
    return [f"conv5_{i}_CPM_L{branch}" for i in range(1, 6)]


def _refine_names(stage, branch):
    return [f"Mconv{i}_stage{stage}_L{branch}" for i in range(1, 8)]


class BodyPoseModel(nn.Module):
    """(N, H, W, 3) -> (pafs, heatmaps) NHWC tensors at 1/8 resolution."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in _BLOCK0:
            self.add_module(
                name, ConvBias(cin, cout, 3, padding=1, act="relu")
            )

        # Stage 1 branches (model.py:58-71); final convs have no ReLU.
        for branch, out_ch in ((1, PAF_CHANNELS), (2, HEATMAP_CHANNELS)):
            for i in range(1, 4):
                self.add_module(f"conv5_{i}_CPM_L{branch}",
                                ConvBias(128, 128, 3, padding=1, act="relu"))
            self.add_module(f"conv5_4_CPM_L{branch}",
                            ConvBias(128, 512, 1, act="relu"))
            self.add_module(f"conv5_5_CPM_L{branch}",
                            ConvBias(512, out_ch, 1))

        # Stages 2-6 (model.py:77-98,120-139).
        for stage in range(2, 7):
            for branch, out_ch in ((1, PAF_CHANNELS), (2, HEATMAP_CHANNELS)):
                cin = STAGE_CHANNELS
                for i in range(1, 6):
                    self.add_module(
                        f"Mconv{i}_stage{stage}_L{branch}",
                        ConvBias(cin, 128, 7, padding=3, act="relu"),
                    )
                    cin = 128
                self.add_module(f"Mconv6_stage{stage}_L{branch}",
                                ConvBias(128, 128, 1, act="relu"))
                # Reference quirk kept for parity: its no-ReLU list names
                # 'Mconv7_stage6_L1' twice instead of L2 (model.py:32-39),
                # so the final stage-6 *heatmap* conv is followed by a
                # ReLU while every other Mconv7 is not.
                act = "relu" if (stage == 6 and branch == 2) else "none"
                self.add_module(f"Mconv7_stage{stage}_L{branch}",
                                ConvBias(128, out_ch, 1, act=act))

    @property
    def compute_dtype(self):
        return self.conv1_1.weight.dtype

    def _branch(self, x, names):
        for name in names:
            x = getattr(self, name)(x)
        return x

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        for name, _, _ in _BLOCK0:
            h = getattr(self, name)(h)
            if name in _POOL_AFTER:
                h = max_pool_2x2(h)
        trunk = h

        paf = self._branch(trunk, _stage1_names(1))
        heat = self._branch(trunk, _stage1_names(2))
        for stage in range(2, 7):
            inp = torch.cat([paf, heat, trunk], dim=1)  # 185 channels
            paf = self._branch(inp, _refine_names(stage, 1))
            heat = self._branch(inp, _refine_names(stage, 2))
        return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)
