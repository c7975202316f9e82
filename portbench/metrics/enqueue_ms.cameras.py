"""As enqueue_ms, in the camera cells."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.enqueue_ms(ctx)
