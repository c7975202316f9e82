"""CUDA kernel records a batch inside the profiled windows."""

from harness import layers  # noqa: F401


def read(ctx):
    return ctx.tracer.launches_per_batch()
