"""Readings shared by the per-layer metric files (``metrics/<name>.py``).
Each returns None where the run gave it nothing to read, and the harness
then leaves the metric out of the result line."""

from harness import bounds, families, flops
from reference.pipeline import resized_shape

ENQUEUE_STAGES = ("perception_step", "pose_dispatch", "embed_dispatch",
                  "limb_dispatch")


def enqueue_ms(ctx):
    """Host ms a batch spent enqueueing device work, from the program's
    own ``StageTimer``, outside the profiled spans."""
    total = ctx.tracer.outside("enqueue_s")
    calls = ctx.tracer.outside("enqueue_calls")
    if not calls:
        return None
    return 1e3 * total / calls


def device_idle_pct(ctx):
    window = ctx.tracer.window_s()
    if not window:
        return None
    return 100.0 * (1.0 - ctx.tracer.busy_s() / window)


def mfu(ctx):
    """The least time the published peaks allow for the convolutions,
    dense layers and products of two activations of the frames
    completed, over the time they took: both outside the profiled spans.
    Each family's work is counted at its input, per frame or, for the
    recognizer, per face embedded, and held to the peak rate of its
    role's precision."""
    frames, faces = ctx.tracer.outside("frames"), ctx.tracer.outside("faces")
    seconds = ctx.tracer.outside_s()
    if not frames or ctx.faces is None or not seconds:
        return None
    c = ctx.cell.pipe_cfg
    h, w = ctx.cell.mix["frame"]
    fams = ctx.cell.families
    per = flops.frame_flops(fams, h, w, c)
    least = 0.0
    for role, fam in fams.items():
        setting = families.PRECISION.get(role)
        rate = (bounds.PEAK_INT8_OPS if setting and c[setting] == "int8"
                else bounds.PEAK_BF16_FLOPS)
        count = faces if role == "recognizer" else frames
        least += per[fam.name] * count / rate
    return 100.0 * least / seconds


def _pair_ms(ctx, first, second):
    a, b = ctx.tracer.kernel_ms(first), ctx.tracer.kernel_ms(second)
    return None if a is None or b is None else a + b


def peaks_roofline(ctx):
    """``kernel_bound_ms`` of one batch's peak scan over the mean device ms
    of one ``scan_kernel`` plus one ``merge_kernel``."""
    ms = _pair_ms(ctx, "scan_kernel", "merge_kernel")
    pose = ctx.cell.families.get("pose")
    if not ms or pose is None:
        return None
    c = ctx.cell.pipe_cfg
    h, w = ctx.cell.mix["frame"]
    ph, pw, _ = resized_shape(h, w, c["pose_short_side"])
    hh, ww = ph // 8, pw // 8  # three 2x2 max pools
    bound, _ = bounds.kernel_bound_ms(
        ctx.cell.mix["batch"] * pose.binding.PARTS, hh, ww, c["max_peaks"])
    return 100.0 * bound / ms


def nms_roofline(ctx):
    """``nms_bound_ms`` on the compared frames' own pre-selected boxes (the
    program's output, at the detection size), batch by batch, over the
    mean device ms of one ``mask_kernel`` plus one ``sweep_kernel``."""
    import numpy as np
    import torch

    ms = _pair_ms(ctx, "mask_kernel", "sweep_kernel")
    if not ms or not ctx.items:
        return None
    c = ctx.cell.pipe_cfg
    h, w = ctx.cell.mix["frame"]
    scale = resized_shape(h, w, c["det_short_side"])[2]
    bound = []
    for _, cands in ctx.items:
        boxes = torch.as_tensor(np.stack([x["boxes"] for x in cands]),
                                dtype=torch.float32) * scale
        valid = torch.isfinite(torch.as_tensor(
            np.stack([x["scores"] for x in cands])))
        keep = torch.as_tensor(np.stack([x["mask"] for x in cands]))
        bound.append(bounds.nms_bound_ms(boxes, valid, keep,
                                         c["nms_threshold"])[0])
    return 100.0 * (sum(bound) / len(bound)) / ms


def int8_mm_roofline(ctx):
    """Least time of the profiled ``aten::_int_mm`` calls at their shapes
    over the device time of the kernels they launched."""
    rows = ctx.tracer.int_mm
    device_s = sum(us for _, us, _ in rows) / 1e6
    if not device_s:
        return None
    least = sum(n * bounds.int_mm_bound_s(*shape) for n, _, shape in rows)
    return 100.0 * least / device_s


def track_ms(ctx):
    """Host ms a batch in the trackers' ``update``, outside the profiled
    spans."""
    batches = ctx.tracer.outside("batches")
    if not batches:
        return None
    return 1e3 * ctx.tracer.outside("track_s") / batches


def batch_fill_ms(ctx):
    return ctx.layer.get("batch_fill_ms")
