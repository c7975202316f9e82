"""Ms from a batch's first frame being due to its last frame being handed
to the multiplexer, from the paced sources' own clock: the median batch
yielded before the first profiled span."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.batch_fill_ms(ctx)
