"""Host ms a batch in the stream trackers' update calls, from the
program's own StageTimer record 'track' (MultiStreamPerception), over the
whole window. Also puts the per-stage table into extra."""

from harness import spans


def read(ctx):
    spans.note_stage_table(ctx)
    return spans.timer_ms(ctx, "track")
