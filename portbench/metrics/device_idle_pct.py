"""One minus the union of all device activity over the profiled windows."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.device_idle_pct(ctx)
