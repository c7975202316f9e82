"""Readings of the pose family's pose programs, from the program's own
StageTimer records ``pose_device``, kept by ``PerceptionPipeline`` where a
batch's peak tables reach the host: one a call of the pose program, its
device seconds (a CUDA event pair around the call, replays of a captured
graph included), items the batch's frames. Each returns None where the
run gave it nothing to read: no timer, no pose family, or a program that
keeps no such record."""

from harness import bounds, families, flops


def pose_device_ms(ctx):
    """Mean device ms of a pose-program call over the run's window."""
    timer = ctx.timer
    calls = timer.counts.get("pose_device", 0) if timer else 0
    if not calls:
        return None
    return 1e3 * timer.times["pose_device"] / calls


def pose_mfu(ctx):
    """The least time of the frames' pose-model operations (counted from
    the family's reference forward at its input, ``harness/flops.py``) at
    the published peak of the pose precision (989 TFLOP/s bf16, 1,979
    TOP/s int8), over the device seconds of the pose calls that ran
    them."""
    timer = ctx.timer
    seconds = timer.times.get("pose_device", 0.0) if timer else 0.0
    pose = ctx.cell.families.get("pose")
    if not seconds or pose is None:
        return None
    c = ctx.cell.pipe_cfg
    per_frame = flops.model_flops(
        pose.name, *pose.binding.input_size(*ctx.cell.mix["frame"], c))
    rate = (bounds.PEAK_INT8_OPS
            if c[families.PRECISION["pose"]] == "int8"
            else bounds.PEAK_BF16_FLOPS)
    return 100.0 * timer.items["pose_device"] * per_frame / rate / seconds
