"""As device_idle_pct, in the camera cells."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.device_idle_pct(ctx)
