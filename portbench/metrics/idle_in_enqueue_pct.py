"""Share of the profiled windows in which the device runs no kernel or
copy on any stream while the dispatching thread is inside one of the
program's enqueue stages (its terran::perception_step, pose_dispatch,
embed_dispatch and limb_dispatch ranges): the idle time that fewer
launches would remove. Also puts the per-stage table into extra."""

from harness import spans


def read(ctx):
    spans.note_stage_table(ctx)
    return spans.idle_in_enqueue_pct(ctx.tracer)
