"""Mean device ms of one call of the recognizer's embed program (warp and
embed of a batch's faces, in the bucket the batch needs), from the
program's StageTimer records 'embed_device': a CUDA event pair around
each call, replays of a captured graph included, over the whole
window."""

from harness import embed  # noqa: F401


def read(ctx):
    return embed.embed_device_ms(ctx)
