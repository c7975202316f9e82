"""The NMS suppression's bound over its two kernels' device time."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.nms_roofline(ctx)
