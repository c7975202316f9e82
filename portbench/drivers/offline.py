"""Closed loop over recorded video: one caller streams seeded 1080p
batches through ``PerceptionPipeline.process_stream`` as fast as the
program takes them, cycling the mix's batches for the whole window.

The window opens at the stream's first result, so the pipeline is full
when it starts; a frame counts when its batch's result is yielded inside
the window. The mix's ``batches`` distinct batches are all compared
with the reference afterwards (the latest result of each, from the
window or the drain after it)."""

import itertools
import time
from collections import deque

import numpy as np

from harness import cell as cellmod


def run(ctx):
    mix, cfg = ctx.cell.mix, ctx.cell.pipe_cfg
    h, w = mix["frame"]
    b, count = mix["batch"], mix["batches"]
    frames = cellmod.make_frames(ctx.seed, b * count, h, w, ctx.device)
    batches = [frames[i * b:(i + 1) * b] for i in range(count)]
    pipe = ctx.build_pipeline()
    recorder = cellmod.PeakRecorder().install()
    cellmod.warm_up(pipe, batches[0], cfg["depth"])
    ctx.setup_done(pipe)

    sent = deque()
    stop = []

    def feed():
        for i in itertools.cycle(range(count)):
            if stop:
                return
            sent.append(i)
            yield batches[i]

    t0 = None
    done = ctx.done
    latest = {}
    for out in pipe.process_stream(feed(), depth=cfg["depth"]):
        t = time.perf_counter()
        i = sent.popleft()
        latest[i] = (out, recorder.take(b))
        if t0 is None:
            t0 = t
            ctx.window_opened(t0)
            continue
        if t - t0 > ctx.seconds:
            stop.append(True)
            continue
        done.frames += b
        done.batches += 1
        done.faces += int(np.asarray(out.get("embeddings_mask", 0)).sum())
        ctx.tracer.step(t)
    ctx.tracer.close()
    ctx.window_closed(done.frames, done.faces)
    items = [(batches[i], cellmod.outputs_of(peaks, out))
             for i, (out, peaks) in sorted(latest.items())]
    return {"attempted": done.frames, "failed": 0,
            "metrics": {"frames_per_s": done.frames / ctx.seconds},
            "items": items, "tracks": None}
