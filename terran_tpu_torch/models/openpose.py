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
from terran_tpu_torch.models.quant import (
    QuantConv2d, keep_float64_copies, quantize_state_dict,
)

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


def _layer_specs():
    """(name, in, out, kernel, padding, act) of every conv, in forward
    order."""
    specs = [(name, cin, cout, 3, 1, "relu") for name, cin, cout in _BLOCK0]
    # Stage 1 branches (model.py:58-71); final convs have no ReLU.
    for branch, out_ch in ((1, PAF_CHANNELS), (2, HEATMAP_CHANNELS)):
        specs += [(f"conv5_{i}_CPM_L{branch}", 128, 128, 3, 1, "relu")
                  for i in range(1, 4)]
        specs += [(f"conv5_4_CPM_L{branch}", 128, 512, 1, 0, "relu"),
                  (f"conv5_5_CPM_L{branch}", 512, out_ch, 1, 0, "none")]
    # Stages 2-6 (model.py:77-98,120-139).
    for stage in range(2, 7):
        for branch, out_ch in ((1, PAF_CHANNELS), (2, HEATMAP_CHANNELS)):
            specs += [(f"Mconv{i}_stage{stage}_L{branch}",
                       STAGE_CHANNELS if i == 1 else 128, 128, 7, 3, "relu")
                      for i in range(1, 6)]
            # Reference quirk kept for parity: its no-ReLU list names
            # 'Mconv7_stage6_L1' twice instead of L2 (model.py:32-39), so
            # the final stage-6 *heatmap* conv is followed by a ReLU while
            # every other Mconv7 is not.
            act = "relu" if (stage == 6 and branch == 2) else "none"
            specs += [(f"Mconv6_stage{stage}_L{branch}", 128, 128, 1, 0,
                       "relu"),
                      (f"Mconv7_stage{stage}_L{branch}", 128, out_ch, 1, 0,
                       act)]
    return specs


class BodyPoseModel(nn.Module):
    """(N, H, W, 3) RGB ``x / 255 - 0.5`` -> (pafs, heatmaps) NHWC tensors
    at 1/8 resolution."""

    input_scale = 255.0

    def __init__(self):
        super().__init__()
        for name, cin, cout, kernel, padding, act in _layer_specs():
            self.add_module(name, ConvBias(cin, cout, kernel,
                                           padding=padding, act=act))

    @classmethod
    def from_state_dict(cls, state_dict, dtype=torch.float32):
        """The model in ``dtype``; the weights are not loaded."""
        return cls().to(dtype=dtype)

    @property
    def compute_dtype(self):
        return self.conv1_1.weight.dtype

    def forward(self, x):
        paf, heat = _cpm_forward(self, x.permute(0, 3, 1, 2), max_pool_2x2,
                                 channel_dim=1)
        return paf.permute(0, 2, 3, 1), heat.permute(0, 2, 3, 1)


def _cpm_forward(model, h, pool, channel_dim):
    """The trunk, stage 1 and stages 2-6 of ``model``'s layers on ``h``;
    ``pool`` halves it after conv1_2, conv2_2 and conv3_4."""

    def branch(x, names):
        for name in names:
            x = getattr(model, name)(x)
        return x

    for name, _, _ in _BLOCK0:
        h = getattr(model, name)(h)
        if name in _POOL_AFTER:
            h = pool(h)
    trunk = h

    paf = branch(trunk, _stage1_names(1))
    heat = branch(trunk, _stage1_names(2))
    for stage in range(2, 7):
        # 185 channels.
        inp = torch.cat([paf, heat, trunk], dim=channel_dim)
        paf = branch(inp, _refine_names(stage, 1))
        heat = branch(inp, _refine_names(stage, 2))
    return paf, heat


# ---------------------------------------------------------------------------
# Opt-in int8 trunk (terran_tpu/models/openpose.py::apply_int8)
# ---------------------------------------------------------------------------
# Every conv runs int8 x int8 -> int32 (models/quant.py); its bias adds in
# float32 after the dequantisation, then the ReLU, then the cast to the
# compute dtype. NHWC throughout, the JAX layout.


class _Int8ConvBias(QuantConv2d):
    """``conv`` of ``apply_int8``: the dequantised conv plus the bias in
    float32 with one rounding, then the ReLU, then the cast to the compute
    dtype (``quant.epilogue_plain``'s bias mode; on the card one kernel
    after the product)."""

    def __init__(self, in_channels, out_channels, kernel, padding, act,
                 dtype):
        super().__init__(in_channels, out_channels, kernel, 1, padding)
        # Stored in the compute dtype (under bf16 it rounds through bf16),
        # widened in the forward.
        self.bias = nn.Parameter(torch.zeros(out_channels, dtype=dtype))
        keep_float64_copies(self, "bias")
        self.act = act

    def forward(self, x):
        return super().forward(x, self.bias.dtype, bias64=self.bias64,
                               relu=self.act == "relu")


def _max_pool_nhwc(x):
    return max_pool_2x2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Int8BodyPoseModel(nn.Module):
    """BodyPoseModel with every conv int8, built in ``compute_dtype``: the
    same call surface and output layout, (N, H, W, 3) -> NHWC (pafs,
    heatmaps). Its state dict comes from :func:`quantize_params` (or
    ``params_from_jax`` of the JAX package's ``quantize_params`` tree)."""

    input_scale = BodyPoseModel.input_scale

    def __init__(self, compute_dtype=torch.float32):
        super().__init__()
        for name, cin, cout, kernel, padding, act in _layer_specs():
            self.add_module(name, _Int8ConvBias(cin, cout, kernel, padding,
                                                act, compute_dtype))

    @property
    def compute_dtype(self):
        return self.conv1_1.bias.dtype

    def forward(self, x):
        return _cpm_forward(self, x.to(self.compute_dtype), _max_pool_nhwc,
                            channel_dim=-1)


def quantize_params(model_or_state_dict, compute_dtype=torch.float32):
    """The :class:`Int8BodyPoseModel` state dict of a float32
    :class:`BodyPoseModel` (or its state dict): every conv int8 +
    per-channel scales, the biases cast to ``compute_dtype``."""
    return quantize_state_dict(model_or_state_dict, compute_dtype,
                               is_conv=lambda prefix: True)
