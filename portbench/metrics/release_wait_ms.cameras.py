"""Host ms a batch waited, dispatched, for later batches before its
results were collected, from the program's StageTimer record
'release_wait' (PerceptionPipeline.process_stream), over the whole
window."""

from harness import spans


def read(ctx):
    spans.note_stage_table(ctx)
    return spans.timer_ms(ctx, "release_wait")
