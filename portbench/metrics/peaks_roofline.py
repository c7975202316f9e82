"""The fused peak scan's bound over its two kernels' device time."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.peaks_roofline(ctx)
