"""A toy face recognizer for the benchmark's tests: a 2 x 2 grid of
tokens from the aligned crop, a dense layer, the Gram product of the
tokens' features and a dense head, L2 normalised."""

import torch.nn.functional as F

from reference import pipeline as ref
from reference.models import FLOAT

TOKENS, WIDTH, EMBED_DIM = 4, 16, 8


def specs():
    return [("embed.weight", (WIDTH, 3), ("normal", 0.01)),
            ("embed.bias", (WIDTH,), ("normal", 0.1)),
            ("head.weight", (EMBED_DIM, WIDTH * WIDTH),
             ("normal", 1.0 / WIDTH)),
            ("head.bias", (EMBED_DIM,), ("normal", 0.1))]


def forward(sd, x, ops=FLOAT):
    """(N, 3, 112, 112) float32 crops in [0, 1] -> (N, 8) features."""
    tokens = F.avg_pool2d(x, x.shape[-1] // 2).flatten(2).transpose(1, 2)
    h = ops.linear(tokens, sd["embed.weight"], sd["embed.bias"])
    gram = ops.matmul(h.transpose(1, 2), h) / TOKENS
    return ops.linear(gram.flatten(1), sd["head.weight"], sd["head.bias"])


def embed(sd, frame, landmarks, ops=FLOAT):
    """(M, 8) unit embeddings of the faces of one uint8 frame at the given
    (M, 5, 2) landmarks."""
    crops = ref.warp(frame, ref.alignment_matrices(landmarks))
    feats = forward(sd, crops.permute(0, 3, 1, 2) / 255.0, ops)
    return F.normalize(feats, dim=-1, eps=1e-12)
