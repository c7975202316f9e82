"""Share of the published peaks that the frames completed needed: the
convolutions' and dense layers' operations, counted from their shapes, at
989 TFLOP/s bf16 or 1,979 TOP/s int8, over the time they took: both
read outside the profiled spans of the traced run."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.mfu(ctx)
