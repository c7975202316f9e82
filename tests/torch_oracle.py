"""Functional torch oracles for conversion/parity tests.

These forwards consume state-dicts keyed with the *reference's* parameter
names (the format the real pretrained ``.pth`` files use) and reproduce the
reference architectures' inference semantics using torch.nn.functional
directly. They serve two purposes:

1. generate synthetic state-dicts with the exact key names/shapes the weight
   converter must handle, and
2. provide independent numerical ground truth: flax-model(convert(sd)) must
   match torch-oracle(sd) on random inputs.

Torch is a test-only dependency; nothing under ``terran_tpu/`` imports it on
the inference path.
"""

import numpy as np
import torch
import torch.nn.functional as F


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _conv(x, sd, name, stride=1, pad=0, groups=1, bias=False):
    w = _t(sd[f"{name}.weight"])
    b = _t(sd[f"{name}.bias"]) if bias else None
    return F.conv2d(x, w, b, stride=stride, padding=pad, groups=groups)


def _bn(x, sd, name, eps):
    return F.batch_norm(
        x, _t(sd[f"{name}.running_mean"]), _t(sd[f"{name}.running_var"]),
        _t(sd[f"{name}.weight"]), _t(sd[f"{name}.bias"]),
        training=False, eps=eps,
    )


def _prelu(x, sd, name):
    return F.prelu(x, _t(sd[f"{name}.weight"]))


def _rand(rng, *shape):
    return rng.normal(scale=0.1, size=shape).astype(np.float32)


def _rand_bn(rng, sd, name, ch):
    sd[f"{name}.weight"] = 1.0 + 0.1 * _rand(rng, ch)
    sd[f"{name}.bias"] = _rand(rng, ch)
    sd[f"{name}.running_mean"] = _rand(rng, ch)
    sd[f"{name}.running_var"] = np.abs(_rand(rng, ch)) + 0.5
    sd[f"{name}.num_batches_tracked"] = np.array(0, dtype=np.int64)


# ---------------------------------------------------------------------------
# RetinaFace
# ---------------------------------------------------------------------------

RF_SEP_BLOCKS = {
    "base.scales.0.0": (8, 16, 2),
    "base.scales.0.1": (16, 32, 1),
    "base.scales.0.2": (32, 32, 2),
    "base.scales.0.3": (32, 64, 1),
    "base.scales.0.4": (64, 64, 2),
    "base.scales.1.0": (64, 128, 1),
    "base.scales.1.1": (128, 128, 1),
    "base.scales.1.2": (128, 128, 1),
    "base.scales.1.3": (128, 128, 1),
    "base.scales.1.4": (128, 128, 1),
    "base.scales.1.5": (128, 128, 2),
    "base.final_conv.0": (128, 256, 1),
}


def random_retinaface_state_dict(rng):
    sd = {}
    sd["base.first_conv_block.0.weight"] = _rand(rng, 8, 3, 3, 3)
    _rand_bn(rng, sd, "base.first_conv_block.1", 8)
    sd["base.first_conv_block.3.weight"] = _rand(rng, 8, 1, 3, 3)
    _rand_bn(rng, sd, "base.first_conv_block.4", 8)

    for prefix, (in_c, out_c, _stride) in RF_SEP_BLOCKS.items():
        sd[f"{prefix}.conv_block.0.weight"] = _rand(rng, out_c, in_c, 1, 1)
        _rand_bn(rng, sd, f"{prefix}.conv_block.1", out_c)
        sd[f"{prefix}.sep_block.0.weight"] = _rand(rng, out_c, 1, 3, 3)
        _rand_bn(rng, sd, f"{prefix}.sep_block.1", out_c)

    sd["base.final_conv.1.weight"] = _rand(rng, 256, 256, 1, 1)
    _rand_bn(rng, sd, "base.final_conv.2", 256)

    # The refiner/context convs keep torch's default bias=True
    # (retinaface/model.py:126-203).
    for name, in_c in (("stride8", 64), ("stride16", 128), ("stride32", 256)):
        sd[f"refiner.conv_{name}.0.weight"] = _rand(rng, 64, in_c, 1, 1)
        sd[f"refiner.conv_{name}.0.bias"] = _rand(rng, 64)
        _rand_bn(rng, sd, f"refiner.conv_{name}.1", 64)
    for name in ("stride8", "stride16"):
        sd[f"refiner.aggr_{name}.0.weight"] = _rand(rng, 64, 64, 3, 3)
        sd[f"refiner.aggr_{name}.0.bias"] = _rand(rng, 64)
        _rand_bn(rng, sd, f"refiner.aggr_{name}.1", 64)
    for stride in (8, 16, 32):
        p = f"refiner.context_stride{stride}"
        sd[f"{p}.context_3x3.0.weight"] = _rand(rng, 32, 64, 3, 3)
        sd[f"{p}.context_3x3.0.bias"] = _rand(rng, 32)
        _rand_bn(rng, sd, f"{p}.context_3x3.1", 32)
        sd[f"{p}.dimension_reducer.0.weight"] = _rand(rng, 16, 64, 3, 3)
        sd[f"{p}.dimension_reducer.0.bias"] = _rand(rng, 16)
        _rand_bn(rng, sd, f"{p}.dimension_reducer.1", 16)
        sd[f"{p}.context_5x5.0.weight"] = _rand(rng, 16, 16, 3, 3)
        sd[f"{p}.context_5x5.0.bias"] = _rand(rng, 16)
        _rand_bn(rng, sd, f"{p}.context_5x5.1", 16)
        sd[f"{p}.context_7x7.0.weight"] = _rand(rng, 16, 16, 3, 3)
        sd[f"{p}.context_7x7.0.bias"] = _rand(rng, 16)
        _rand_bn(rng, sd, f"{p}.context_7x7.1", 16)
        sd[f"{p}.context_7x7.3.weight"] = _rand(rng, 16, 16, 3, 3)
        sd[f"{p}.context_7x7.3.bias"] = _rand(rng, 16)
        _rand_bn(rng, sd, f"{p}.context_7x7.4", 16)
    for stride in (8, 16, 32):
        for head, ch in (("cls", 4), ("bbox", 8), ("landmark", 20)):
            sd[f"outputs.{head}_stride{stride}.weight"] = _rand(rng, ch, 64, 1, 1)
            sd[f"outputs.{head}_stride{stride}.bias"] = _rand(rng, ch)
    return sd


def retinaface_forward(sd, images_bgr_nchw):
    """Reference RetinaFace semantics, functional form. Returns the 9-tensor
    list [cls32, bbox32, lmk32, cls16, ..., lmk8] with softmax'd cls."""
    eps_b, eps_f = 1e-5, 2e-5
    x = torch.as_tensor(images_bgr_nchw, dtype=torch.float32)

    def conv_bn(x, conv, bn, eps, stride=1, pad=0, groups=1, bias=False):
        x = _conv(x, sd, conv, stride=stride, pad=pad, groups=groups, bias=bias)
        return F.relu(_bn(x, sd, bn, eps))

    x = conv_bn(x, "base.first_conv_block.0", "base.first_conv_block.1",
                eps_b, stride=2, pad=1)
    x = conv_bn(x, "base.first_conv_block.3", "base.first_conv_block.4",
                eps_b, pad=1, groups=8)

    feats = []
    for prefix, (_in_c, out_c, stride) in RF_SEP_BLOCKS.items():
        conv = conv_bn(
            x, f"{prefix}.conv_block.0", f"{prefix}.conv_block.1", eps_b
        )
        x = conv_bn(
            conv, f"{prefix}.sep_block.0", f"{prefix}.sep_block.1", eps_b,
            stride=stride, pad=1, groups=out_c,
        )
        if prefix in ("base.scales.0.4", "base.scales.1.5"):
            feats.append(conv)
    feats.append(conv_bn(x, "base.final_conv.1", "base.final_conv.2", eps_b))

    f8, f16, f32 = feats
    p8 = conv_bn(f8, "refiner.conv_stride8.0", "refiner.conv_stride8.1", eps_f,
                 bias=True)
    p16 = conv_bn(f16, "refiner.conv_stride16.0", "refiner.conv_stride16.1",
                  eps_f, bias=True)
    p32 = conv_bn(f32, "refiner.conv_stride32.0", "refiner.conv_stride32.1",
                  eps_f, bias=True)

    ups32 = F.interpolate(p32, scale_factor=2)[:, :, : p16.shape[2], : p16.shape[3]]
    p16 = conv_bn(p16 + ups32, "refiner.aggr_stride16.0",
                  "refiner.aggr_stride16.1", eps_f, pad=1, bias=True)
    ups16 = F.interpolate(p16, scale_factor=2)[:, :, : p8.shape[2], : p8.shape[3]]
    p8 = conv_bn(p8 + ups16, "refiner.aggr_stride8.0", "refiner.aggr_stride8.1",
                 eps_f, pad=1, bias=True)

    def context(x, p):
        ctx3 = conv_bn(x, f"{p}.context_3x3.0", f"{p}.context_3x3.1", eps_f,
                       pad=1, bias=True)
        red = conv_bn(x, f"{p}.dimension_reducer.0", f"{p}.dimension_reducer.1",
                      eps_f, pad=1, bias=True)
        ctx5 = conv_bn(red, f"{p}.context_5x5.0", f"{p}.context_5x5.1", eps_f,
                       pad=1, bias=True)
        ctx7 = conv_bn(red, f"{p}.context_7x7.0", f"{p}.context_7x7.1", eps_f,
                       pad=1, bias=True)
        ctx7 = conv_bn(ctx7, f"{p}.context_7x7.3", f"{p}.context_7x7.4", eps_f,
                       pad=1, bias=True)
        return torch.cat([ctx3, ctx5, ctx7], dim=1)

    c8 = context(p8, "refiner.context_stride8")
    c16 = context(p16, "refiner.context_stride16")
    c32 = context(p32, "refiner.context_stride32")

    outs = []
    for stride, feat in ((32, c32), (16, c16), (8, c8)):
        cls = _conv(feat, sd, f"outputs.cls_stride{stride}", bias=True)
        n, a, h, w = cls.shape
        cls = F.softmax(cls.reshape(n, 2, -1, w), dim=1).reshape(n, a, h, w)
        box = _conv(feat, sd, f"outputs.bbox_stride{stride}", bias=True)
        lmk = _conv(feat, sd, f"outputs.landmark_stride{stride}", bias=True)
        outs.extend([cls, box, lmk])
    return outs


# ---------------------------------------------------------------------------
# ArcFace
# ---------------------------------------------------------------------------

ARC_UNITS = (3, 13, 30, 3)
ARC_CHANNELS = (64, 64, 128, 256, 512)


def random_arcface_state_dict(rng):
    # Conv weights are fan-in scaled: with N(0, 0.1) weights the 46 residual
    # units would blow the activations up to inf (each body conv multiplies
    # variance by fan_in * 0.01) and the parity test would compare NaNs.
    def conv_w(o, i, kh, kw):
        std = 0.5 / np.sqrt(i * kh * kw)
        return rng.normal(scale=std, size=(o, i, kh, kw)).astype(np.float32)

    sd = {}
    sd["initial_layer.0.weight"] = conv_w(64, 3, 3, 3)
    _rand_bn(rng, sd, "initial_layer.1", 64)
    sd["initial_layer.2.weight"] = np.abs(_rand(rng, 64))

    for stage, num_units in enumerate(ARC_UNITS):
        in_c, out_c = ARC_CHANNELS[stage], ARC_CHANNELS[stage + 1]
        for unit in range(num_units):
            p = f"stages.{stage}.{unit}"
            cur_in = in_c if unit == 0 else out_c
            _rand_bn(rng, sd, f"{p}.body.0", cur_in)
            sd[f"{p}.body.1.weight"] = conv_w(out_c, cur_in, 3, 3)
            _rand_bn(rng, sd, f"{p}.body.2", out_c)
            sd[f"{p}.body.3.weight"] = np.abs(_rand(rng, out_c))
            sd[f"{p}.body.4.weight"] = conv_w(out_c, out_c, 3, 3)
            _rand_bn(rng, sd, f"{p}.body.5", out_c)
            if unit == 0:
                sd[f"{p}.shortcut.0.weight"] = conv_w(out_c, cur_in, 1, 1)
                _rand_bn(rng, sd, f"{p}.shortcut.1", out_c)

    _rand_bn(rng, sd, "final_layer.0", 512)
    sd["final_layer.3.weight"] = rng.normal(
        scale=1.0 / np.sqrt(7 * 7 * 512), size=(512, 7 * 7 * 512)
    ).astype(np.float32)
    sd["final_layer.3.bias"] = _rand(rng, 512)
    _rand_bn(rng, sd, "final_layer.4", 512)
    return sd


def arcface_forward(sd, images_bgr_nchw):
    eps = 2e-5
    x = torch.as_tensor(images_bgr_nchw, dtype=torch.float32)
    x = (x - 127.5) * 0.0078125

    x = _conv(x, sd, "initial_layer.0", pad=1)
    x = _bn(x, sd, "initial_layer.1", eps)
    x = _prelu(x, sd, "initial_layer.2")

    for stage, num_units in enumerate(ARC_UNITS):
        for unit in range(num_units):
            p = f"stages.{stage}.{unit}"
            stride = 2 if unit == 0 else 1
            body = _bn(x, sd, f"{p}.body.0", eps)
            body = _conv(body, sd, f"{p}.body.1", pad=1)
            body = _bn(body, sd, f"{p}.body.2", eps)
            body = _prelu(body, sd, f"{p}.body.3")
            body = _conv(body, sd, f"{p}.body.4", stride=stride, pad=1)
            body = _bn(body, sd, f"{p}.body.5", eps)
            if unit == 0:
                shortcut = _conv(x, sd, f"{p}.shortcut.0", stride=stride)
                shortcut = _bn(shortcut, sd, f"{p}.shortcut.1", eps)
            else:
                shortcut = x
            x = body + shortcut

    x = _bn(x, sd, "final_layer.0", eps)
    x = torch.flatten(x, 1)
    x = F.linear(x, _t(sd["final_layer.3.weight"]), _t(sd["final_layer.3.bias"]))
    x = F.batch_norm(
        x, _t(sd["final_layer.4.running_mean"]), _t(sd["final_layer.4.running_var"]),
        _t(sd["final_layer.4.weight"]), _t(sd["final_layer.4.bias"]),
        training=False, eps=eps,
    )
    return x


# ---------------------------------------------------------------------------
# OpenPose
# ---------------------------------------------------------------------------

OP_BLOCK0 = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256),
    ("conv3_3", 256, 256), ("conv3_4", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512),
    ("conv4_3_CPM", 512, 256), ("conv4_4_CPM", 256, 128),
)


def random_openpose_state_dict(rng):
    # Fan-in-scaled weights keep activations O(1) through the 40+ convs so
    # the parity comparison is numerically meaningful.
    def conv_w(o, i, k):
        std = 1.0 / np.sqrt(i * k * k)
        return rng.normal(scale=std, size=(o, i, k, k)).astype(np.float32)

    sd = {}
    for name, in_c, out_c in OP_BLOCK0:
        sd[f"model0.{name}.weight"] = conv_w(out_c, in_c, 3)
        sd[f"model0.{name}.bias"] = _rand(rng, out_c)
    for branch, out_final in ((1, 38), (2, 19)):
        chans = [(128, 128, 3), (128, 128, 3), (128, 128, 3), (128, 512, 1),
                 (512, out_final, 1)]
        for i, (in_c, out_c, k) in enumerate(chans, start=1):
            name = f"model1_{branch}.conv5_{i}_CPM_L{branch}"
            sd[f"{name}.weight"] = conv_w(out_c, in_c, k)
            sd[f"{name}.bias"] = _rand(rng, out_c)
    for stage in range(2, 7):
        for branch, out_final in ((1, 38), (2, 19)):
            chans = [(185, 128, 7)] + [(128, 128, 7)] * 4 + [
                (128, 128, 1), (128, out_final, 1)]
            for i, (in_c, out_c, k) in enumerate(chans, start=1):
                name = f"model{stage}_{branch}.Mconv{i}_stage{stage}_L{branch}"
                sd[f"{name}.weight"] = conv_w(out_c, in_c, k)
                sd[f"{name}.bias"] = _rand(rng, out_c)
    return sd


def openpose_forward(sd, images_nchw):
    """Reference BodyPoseModel semantics, functional form; returns
    (pafs, heatmaps). Keeps the reference's stage-6 L2 ReLU quirk
    (no_relu_layers lists Mconv7_stage6_L1 twice, model.py:32-39)."""
    x = torch.as_tensor(images_nchw, dtype=torch.float32)

    def conv(x, name, pad, relu=True):
        x = _conv(x, sd, name, pad=pad, bias=True)
        return F.relu(x) if relu else x

    h = x
    pools_after = {"conv1_2", "conv2_2", "conv3_4"}
    for name, _i, _o in OP_BLOCK0:
        h = conv(h, f"model0.{name}", pad=1)
        if name in pools_after:
            h = F.max_pool2d(h, 2, 2)
    trunk = h

    def stage1(branch):
        h = trunk
        for i in (1, 2, 3):
            h = conv(h, f"model1_{branch}.conv5_{i}_CPM_L{branch}", pad=1)
        h = conv(h, f"model1_{branch}.conv5_4_CPM_L{branch}", pad=0)
        return conv(h, f"model1_{branch}.conv5_5_CPM_L{branch}", pad=0,
                    relu=False)

    paf, heat = stage1(1), stage1(2)
    for stage in range(2, 7):
        inp = torch.cat([paf, heat, trunk], dim=1)

        def refine(branch, stage=stage, inp=inp):
            h = inp
            for i in range(1, 6):
                h = conv(h, f"model{stage}_{branch}.Mconv{i}_stage{stage}_L{branch}",
                         pad=3)
            h = conv(h, f"model{stage}_{branch}.Mconv6_stage{stage}_L{branch}",
                     pad=0)
            relu = stage == 6 and branch == 2
            return conv(
                h, f"model{stage}_{branch}.Mconv7_stage{stage}_L{branch}",
                pad=0, relu=relu,
            )

        paf, heat = refine(1), refine(2)
    return paf, heat


# ---------------------------------------------------------------------------
# The ViT recognizer of insightface's arcface_torch (backbones/vit.py)
# ---------------------------------------------------------------------------

VIT_PATCH = 9


def random_vit_state_dict(rng, depth=2, dim=64, mlp_dim=256, tokens=144,
                          embedding_dim=512):
    """A ``VisionTransformer`` state dict in arcface_torch's key names, at
    any depth and width. Dense weights are fan-in scaled, so that the
    residual stream and the flattened head keep their size; biases,
    LayerNorm and BatchNorm parameters are drawn, so that each counts."""
    def linear(o, i):
        return rng.normal(scale=1.0 / np.sqrt(i), size=(o, i)).astype(
            np.float32)

    k = 3 * VIT_PATCH * VIT_PATCH
    sd = {"patch_embed.proj.weight": rng.normal(
              scale=1.0 / np.sqrt(k), size=(dim, 3, VIT_PATCH, VIT_PATCH)
          ).astype(np.float32),
          "patch_embed.proj.bias": _rand(rng, dim),
          "pos_embed": _rand(rng, 1, tokens, dim),
          "mask_token": _rand(rng, 1, 1, dim)}
    for i in range(depth):
        p = f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{p}.{norm}.weight"] = 1.0 + _rand(rng, dim)
            sd[f"{p}.{norm}.bias"] = _rand(rng, dim)
        sd[f"{p}.attn.qkv.weight"] = linear(3 * dim, dim)
        sd[f"{p}.attn.proj.weight"] = linear(dim, dim)
        sd[f"{p}.attn.proj.bias"] = _rand(rng, dim)
        sd[f"{p}.mlp.fc1.weight"] = linear(mlp_dim, dim)
        sd[f"{p}.mlp.fc1.bias"] = _rand(rng, mlp_dim)
        sd[f"{p}.mlp.fc2.weight"] = linear(dim, mlp_dim)
        sd[f"{p}.mlp.fc2.bias"] = _rand(rng, dim)
    sd["norm.weight"] = 1.0 + _rand(rng, dim)
    sd["norm.bias"] = _rand(rng, dim)
    sd["feature.0.weight"] = linear(dim, tokens * dim)
    _rand_bn(rng, sd, "feature.1", dim)
    sd["feature.2.weight"] = linear(embedding_dim, dim)
    _rand_bn(rng, sd, "feature.3", embedding_dim)
    return sd


def vit_forward(sd, images_rgb_nchw, heads):
    """arcface_torch's ``VisionTransformer.forward`` at inference, in
    float32: (N, 3, 112, 112) RGB crops in [0, 255] -> (N, E) features."""
    x = torch.as_tensor(images_rgb_nchw, dtype=torch.float32)
    x = (x / 255.0 - 0.5) / 0.5
    x = _conv(x, sd, "patch_embed.proj", stride=VIT_PATCH, bias=True)
    x = x.flatten(2).transpose(1, 2) + _t(sd["pos_embed"])
    n, t, c = x.shape

    def ln(x, name):
        return F.layer_norm(x, (c,), _t(sd[f"{name}.weight"]),
                            _t(sd[f"{name}.bias"]), eps=1e-5)

    def linear(x, name, bias=True):
        return F.linear(x, _t(sd[f"{name}.weight"]),
                        _t(sd[f"{name}.bias"]) if bias else None)

    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        p = f"blocks.{i}"
        qkv = linear(ln(x, f"{p}.norm1"), f"{p}.attn.qkv", bias=False)
        q, k, v = qkv.reshape(n, t, 3, heads, c // heads).permute(2, 0, 3,
                                                                  1, 4)
        attn = ((q @ k.transpose(-2, -1)) * (c // heads) ** -0.5).softmax(-1)
        a = (attn @ v).transpose(1, 2).reshape(n, t, c)
        x = x + linear(a, f"{p}.attn.proj")
        h = F.relu6(linear(ln(x, f"{p}.norm2"), f"{p}.mlp.fc1"))
        x = x + linear(h, f"{p}.mlp.fc2")
        i += 1
    x = ln(x, "norm").reshape(n, -1)
    x = _bn(linear(x, "feature.0", bias=False), sd, "feature.1", 2e-5)
    return _bn(linear(x, "feature.2", bias=False), sd, "feature.3", 2e-5)
