"""The ViT face recognizer of insightface's ``arcface_torch`` in plain
PyTorch, float32: ``backbones/vit.py::VisionTransformer`` as
``get_model("vit_l_dp005_mask_005")`` builds it (ViT, arXiv:2010.11929;
trained with Partial FC, arXiv:2203.15565, on WebFace42M,
arXiv:2103.04098), on state dicts in its key format.

It imports nothing of the program or its tests. Every convolution, dense
layer and product of two activations goes through an ``ops`` object
(``reference/models.py``), so that the same forward computes the float32
reference, the control in a lower precision and the benchmark's
operation count.

Departures from ``backbones/vit.py``:

- inference only: the token masking (``mask_ratio``), drop-path and
  dropout, all training-only, are left out, and ``mask_token`` is read
  by nothing;
- everything runs in float32, where the published code runs the dense
  layers under fp16 autocast (its attention core, LayerNorms and
  residual stream are float32 there too);
- the two dense layers without a bias (``qkv`` and the head's) are given
  a zero bias, so that every dense layer takes one ``ops.linear`` form.

``vit_l_specs`` draws the weights as ``VisionTransformer._init_weights``
initialises them, with two changes: the truncated normal of std 0.02 is
drawn as a plain normal (its cut at +-2 lies 100 standard deviations
out), and the head's BatchNorm statistics are drawn like the other
families' (``reference/models.py::_bn_specs``) where the published
initialisation leaves them at 0 and 1. The patch conv keeps PyTorch's
default initialisation's standard deviation, drawn normal."""

import torch
import torch.nn.functional as F

from reference import pipeline as ref
from reference.models import FLOAT, _bn_specs

DEPTH = 24
DIM = 768
HEADS = 8
MLP_DIM = 3072
PATCH = 9
TOKENS = (ref.CROP // PATCH) ** 2  # 144: the last 4 rows and columns unread
EMBED_DIM = 512
LN_EPS = 1e-5
BN_EPS = 2e-5


def vit_l_specs():
    """(key, shape, init) of the published checkpoint's state dict."""
    k = 3 * PATCH * PATCH
    default = (1.0 / (3 * k)) ** 0.5  # kaiming_uniform(a=sqrt(5))'s std
    s = [("patch_embed.proj.weight", (DIM, 3, PATCH, PATCH),
          ("normal", default)),
         ("patch_embed.proj.bias", (DIM,), ("normal", default)),
         ("pos_embed", (1, TOKENS, DIM), ("normal", 0.02)),
         ("mask_token", (1, 1, DIM), ("normal", 0.02))]

    def norm(name):
        return [(f"{name}.weight", (DIM,), ("one_plus", 0.0)),
                (f"{name}.bias", (DIM,), ("normal", 0.0))]

    for i in range(DEPTH):
        p = f"blocks.{i}"
        s += norm(f"{p}.norm1")
        s += [(f"{p}.attn.qkv.weight", (3 * DIM, DIM), ("normal", 0.02)),
              (f"{p}.attn.proj.weight", (DIM, DIM), ("normal", 0.02)),
              (f"{p}.attn.proj.bias", (DIM,), ("normal", 0.0))]
        s += norm(f"{p}.norm2")
        s += [(f"{p}.mlp.fc1.weight", (MLP_DIM, DIM), ("normal", 0.02)),
              (f"{p}.mlp.fc1.bias", (MLP_DIM,), ("normal", 0.0)),
              (f"{p}.mlp.fc2.weight", (DIM, MLP_DIM), ("normal", 0.02)),
              (f"{p}.mlp.fc2.bias", (DIM,), ("normal", 0.0))]
    s += norm("norm")
    s += [("feature.0.weight", (DIM, TOKENS * DIM), ("normal", 0.02))]
    s += _bn_specs("feature.1", DIM)
    s += [("feature.2.weight", (EMBED_DIM, DIM), ("normal", 0.02))]
    s += _bn_specs("feature.3", EMBED_DIM)
    return s


def _check_tf32(x):
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("the float32 reference needs TF32 off")


def _dense(ops, x, sd, name):
    w = sd[f"{name}.weight"]
    b = sd.get(f"{name}.bias")
    return ops.linear(x, w, x.new_zeros(w.shape[0]) if b is None else b)


def _bn(x, sd, name):
    return F.batch_norm(x, sd[f"{name}.running_mean"],
                        sd[f"{name}.running_var"], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], training=False, eps=BN_EPS)


def vit_l_forward(sd, x, ops=FLOAT, heads=HEADS):
    """(N, 3, 112, 112) float32 RGB crops in [0, 255] -> (N, 512)
    features, not normalised. Depth and width follow ``sd``."""
    _check_tf32(x)
    x = (x / 255.0 - 0.5) / 0.5
    x = ops.conv(x, sd["patch_embed.proj.weight"], sd["patch_embed.proj.bias"],
                 stride=PATCH)
    x = x.flatten(2).transpose(1, 2) + sd["pos_embed"]
    n, t, c = x.shape

    def ln(x, name):
        return F.layer_norm(x, (c,), sd[f"{name}.weight"],
                            sd[f"{name}.bias"], eps=LN_EPS)

    i = 0
    while f"blocks.{i}.norm1.weight" in sd:
        p = f"blocks.{i}"
        qkv = _dense(ops, ln(x, f"{p}.norm1"), sd, f"{p}.attn.qkv")
        q, k, v = qkv.reshape(n, t, 3, heads, c // heads).permute(2, 0, 3,
                                                                  1, 4)
        scores = ops.matmul(q, k.transpose(-2, -1)) * (c // heads) ** -0.5
        a = ops.matmul(scores.softmax(dim=-1), v)
        x = x + _dense(ops, a.transpose(1, 2).reshape(n, t, c), sd,
                       f"{p}.attn.proj")
        h = F.relu6(_dense(ops, ln(x, f"{p}.norm2"), sd, f"{p}.mlp.fc1"))
        x = x + _dense(ops, h, sd, f"{p}.mlp.fc2")
        i += 1
    x = ln(x, "norm").reshape(n, t * c)
    x = _bn(_dense(ops, x, sd, "feature.0"), sd, "feature.1")
    return _bn(_dense(ops, x, sd, "feature.2"), sd, "feature.3")


def embed(sd, frame, landmarks, ops=FLOAT):
    """(M, 512) unit embeddings of the faces of one uint8 RGB frame at the
    given (M, 5, 2) full-resolution landmarks: the shared alignment and
    warp, the ViT on the RGB crops, L2 normalisation."""
    crops = ref.warp(frame, ref.alignment_matrices(landmarks))
    feats = vit_l_forward(sd, crops.permute(0, 3, 1, 2), ops)
    return F.normalize(feats, dim=-1, eps=1e-12)
