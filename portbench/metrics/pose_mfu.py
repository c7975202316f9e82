"""Share of the published peak that the frames' pose network needed, over
the device time of the pose calls that ran them ('pose_device' records):
the pose family's operations a frame, counted from its reference
forward's shapes, at 989 TFLOP/s bf16 (1,979 TOP/s int8)."""

from harness import pose  # noqa: F401


def read(ctx):
    return pose.pose_mfu(ctx)
