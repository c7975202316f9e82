"""The int8 trunks' aten::_int_mm calls: bound over device time."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.int8_mm_roofline(ctx)
