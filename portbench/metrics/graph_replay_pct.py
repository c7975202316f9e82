"""Share of the pipeline's device-program calls that replayed a captured
CUDA graph, from the program's StageTimer records 'graph_replay' and
'graph_eager' (one a call, PerceptionPipeline._program), over the whole
window. A pipeline that captures no graph reads 0."""


def read(ctx):
    timer = ctx.timer
    if timer is None:
        return None
    replayed = timer.counts.get("graph_replay", 0)
    calls = replayed + timer.counts.get("graph_eager", 0)
    return 100.0 * replayed / calls if calls else None
