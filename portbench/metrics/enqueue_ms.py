"""Host ms a batch in the pipeline's enqueue stages (perception_step,
pose_dispatch, embed_dispatch, limb_dispatch), from its StageTimer,
outside the profiled spans."""

from harness import layers  # noqa: F401


def read(ctx):
    return layers.enqueue_ms(ctx)
