"""Share of the batches that ``process_stream`` yielded early, while its
feed had no next batch ready, from the program's StageTimer records
'release_early' and 'release_depth' (one a yielded batch,
PerceptionPipeline.process_stream), over the whole window. A program
that makes neither record reads nothing."""


def read(ctx):
    timer = ctx.timer
    if timer is None:
        return None
    early = timer.counts.get("release_early", 0)
    released = early + timer.counts.get("release_depth", 0)
    return 100.0 * early / released if released else None
