"""Share of the published peaks that the faces embedded needed, over the
device time of the embed calls that embedded them ('embed_device'
records): the recognizer's operations a face, counted from its reference
forward's shapes, its products of two activations at 67 TFLOP/s where
the recognizer runs its attention in float32, the rest at 989 TFLOP/s
bf16 (1,979 TOP/s int8)."""

from harness import embed  # noqa: F401


def read(ctx):
    return embed.embed_mfu(ctx)
