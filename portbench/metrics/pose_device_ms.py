"""Mean device ms of one call of the pose family's pose program (the
resize, the pose network and the fused peak scan of a batch), from the
program's StageTimer records 'pose_device': a CUDA event pair around each
call, replays of a captured graph included, over the whole window."""

from harness import pose  # noqa: F401


def read(ctx):
    return pose.pose_device_ms(ctx)
