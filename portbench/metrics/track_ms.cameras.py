"""Host ms a batch in the stream trackers' update calls, timed around the
MultiStreamPerception instance's own trackers, outside the profiled
spans."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.track_ms(ctx)
