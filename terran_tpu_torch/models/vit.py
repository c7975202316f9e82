"""The ViT face recognizer of insightface's ``arcface_torch`` in PyTorch.

``backbones/vit.py::VisionTransformer`` at inference (``get_model
("vit_l_dp005_mask_005")``: 24 blocks of width 768, 8 heads; masking,
drop-path and dropout are training-only and omitted):

- input: an aligned RGB 112x112 crop as ``inference.py`` feeds it,
  ``(x / 255 - 0.5) / 0.5``;
- patch embedding: a 9x9 stride-9 conv with bias, 12 x 12 = 144 tokens
  (the crop's last 4 rows and columns are never read), plus
  ``pos_embed``;
- pre-norm blocks: ``x += proj(attn(LN1(x)))`` with ``qkv`` (no bias)
  and ``softmax(q k^T * d^-1/2) v`` over the heads, then ``x +=
  fc2(ReLU6(fc1(LN2(x))))``; LayerNorm eps 1e-5;
- a final LayerNorm, the tokens flattened token-major, ``Linear(no
  bias) -> BatchNorm1d -> Linear(no bias) -> BatchNorm1d`` (eps 2e-5),
  the BatchNorms on their running statistics.

Precision, as ``arcface_torch`` runs it under fp16 autocast, with the
compute dtype in fp16's place: the patch embedding and every dense layer
run in the compute dtype; the residual stream, the LayerNorms, the
attention core (``Attention.forward`` leaves autocast and upcasts q, k
and v) and the BatchNorms run in float32.

The patch embedding runs as a dense layer over the 144 patches, each
flattened in the conv weight's (channel, row, column) order: the same
products as the conv. The module takes its depth, width, MLP width,
token count and embedding width from its weights' shapes
(:meth:`ViTRecognizer.from_state_dict`); the number of heads is given.
"""

import torch
import torch.nn.functional as F
from torch import nn

PATCH = 9
CROP = 112
HEADS = 8
LN_EPS = 1e-5


def attention(q, k, v):
    """``softmax(q k^T * d^-1/2) v`` over (..., tokens, d) float32 q, k
    and v, in float32: the product, the scale, the softmax and the product
    with v in the order of ``arcface_torch``'s ``Attention.forward``."""
    scores = torch.matmul(q, k.transpose(-2, -1)) * q.shape[-1] ** -0.5
    return torch.matmul(scores.softmax(dim=-1), v)


class Block(nn.Module):
    """One pre-norm transformer block; the residual stream stays float32
    and every dense layer runs in ``dtype``."""

    def __init__(self, dim, heads, mlp_dim, dtype):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False, dtype=dtype)
        self.proj = nn.Linear(dim, dim, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, mlp_dim, dtype=dtype)
        self.fc2 = nn.Linear(mlp_dim, dim, dtype=dtype)

    def forward(self, x):
        b, n, c = x.shape
        dtype = self.qkv.weight.dtype
        qkv = self.qkv(self.norm1(x).to(dtype))
        # One copy upcasts q, k and v, each contiguous (B, heads, n, d);
        # the layout copies change no value.
        q, k, v = qkv.reshape(b, n, 3, self.heads, c // self.heads).permute(
            2, 0, 3, 1, 4).to(torch.float32,
                              memory_format=torch.contiguous_format)
        a = attention(q, k, v).transpose(1, 2).to(
            dtype, memory_format=torch.contiguous_format).reshape(b, n, c)
        # A bf16 output adds into the float32 stream exactly: the add
        # promotes it.
        x = x + self.proj(a)
        return x + self.fc2(F.relu6(self.fc1(self.norm2(x).to(dtype))))


class ViTRecognizer(nn.Module):
    """(B, 112, 112, 3) RGB crops in [0, 255] -> unnormalised (B, E)
    float32 features. Dense layers are built in ``dtype``, the LayerNorms,
    ``pos_embed`` and the BatchNorms (``bn1``, ``bn2``) in float32."""

    def __init__(self, depth=24, dim=768, heads=HEADS, mlp_dim=3072,
                 tokens=144, embedding_dim=512, dtype=torch.float32):
        super().__init__()
        self.grid = round(tokens ** 0.5)
        if self.grid ** 2 != tokens or self.grid * PATCH > CROP:
            raise ValueError(f"{tokens} tokens are no square grid of "
                             f"{PATCH}-pixel patches in a {CROP}-pixel crop")
        if dim % heads:
            raise ValueError(f"width {dim} is not a multiple of {heads} "
                             "heads")
        self.patch_embed = nn.Linear(3 * PATCH * PATCH, dim, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, mlp_dim, dtype) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.embed1 = nn.Linear(tokens * dim, dim, bias=False, dtype=dtype)
        self.bn1 = _BatchNorm(dim)
        self.embed2 = nn.Linear(dim, embedding_dim, bias=False, dtype=dtype)
        self.bn2 = _BatchNorm(embedding_dim)

    @classmethod
    def from_state_dict(cls, state_dict, dtype=torch.float32, heads=HEADS):
        """A model shaped to ``state_dict`` (this module's keys, as
        ``utils.convert.convert_vit_l`` gives them), its dense layers in
        ``dtype``; the weights are not loaded."""
        tokens, dim = state_dict["pos_embed"].shape[1:]
        depth = len({key.split(".")[1] for key in state_dict
                     if key.startswith("blocks.")})
        return cls(depth=depth, dim=dim, heads=heads,
                   mlp_dim=state_dict["blocks.0.fc1.weight"].shape[0],
                   tokens=tokens,
                   embedding_dim=state_dict["embed2.weight"].shape[0],
                   dtype=dtype)

    @property
    def compute_dtype(self):
        return self.patch_embed.weight.dtype

    def forward(self, x):
        b = x.shape[0]
        side = self.grid * PATCH
        x = (x.to(torch.float32) / 255.0 - 0.5) / 0.5
        # (B, H, W, C) -> (B, tokens, C * PATCH * PATCH), each patch in the
        # conv weight's (channel, row, column) order.
        x = x[:, :side, :side].reshape(b, self.grid, PATCH, self.grid,
                                       PATCH, 3)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, self.grid ** 2, -1)
        x = self.pos_embed + self.patch_embed(x.to(self.compute_dtype))
        for block in self.blocks:
            x = block(x)
        x = self.norm(x).reshape(b, -1)
        x = self.bn1(self.embed1(x.to(self.compute_dtype)).float())
        return self.bn2(self.embed2(x.to(self.compute_dtype)).float())


class _BatchNorm(nn.BatchNorm1d):
    """The head's BatchNorm1d (eps 2e-5) on its running statistics, in
    train mode too."""

    def __init__(self, features):
        super().__init__(features, eps=2e-5)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)
