"""Open loop of live cameras: the mix's cameras, each a paced source at
the same rate with phases staggered by a quarter of a frame interval,
through ``MultiStreamPerception(pipe, sources, batch_size, track=True)``.

Each camera cycles a pool of seeded frames; the mix's pool of one frame
is a static camera, whose detections persist from frame to frame so that
its tracker holds one track a face. A frame's latency runs from its due
time to the yield of its tracked result. Every frame due in the window
is waited for after the window closes (the sources then end and the
multiplexer flushes its last batch). The comparison reads what the
public entry points return: each batch's result as the pipeline's
``process_stream`` yields it to the multiplexer, and each frame's tracks
as ``MultiStreamPerception`` yields them. A sample of the window's
batches drawn from the seed is compared with the reference afterwards,
and every tracker call is replayed. The trackers' ``update`` calls are
timed, and nothing more, for ``track_ms.cameras``."""

import random
import time

import numpy as np

from harness import cell as cellmod
from harness.sources import PacedSource
from harness.stats import percentile


def _p50_ms(values):
    return 1e3 * percentile(values, 50) if values else None


def _warm_streams(pipe, sources, batch):
    """Two batches through a throwaway ``MultiStreamPerception`` on
    unpaced copies of the sources, in set-up: the multiplexer, the
    trackers' first calls and the stream's threads, as the window will
    run them."""
    from terran_tpu_torch.io.streams import MultiStreamPerception
    from terran_tpu_torch.io.video import EndOfVideo

    count, rate = -(-2 * batch // len(sources)), 1e4
    copies = [PacedSource(s.pool, rate, offset=0.0, end_error=EndOfVideo)
              for s in sources]
    start = time.perf_counter()
    for c in copies:
        c.schedule(start, start + (count - 0.5) / rate)
    for _ in MultiStreamPerception(pipe, copies, batch_size=batch,
                                   track=True):
        pass


def _time_tracker(tracker, clock):
    update = tracker.update

    def timed(faces):
        start = clock()
        out = update(faces)
        clock.track_s += clock() - start
        clock.held += len(tracker.trackers)
        return out

    tracker.update = timed


def _record_outputs(pipe, recorder):
    """Keep each result the pipeline's ``process_stream`` yields, with its
    frames' peak tables, in order: [(out, peaks)]."""
    stream, outs = pipe.process_stream, []

    def recorded(batches, *args, **kwargs):
        for out in stream(batches, *args, **kwargs):
            outs.append((out, recorder.take(len(out["mask"]))))
            yield out

    pipe.process_stream = recorded
    return outs


class _Clock:
    def __init__(self):
        self.track_s = 0.0
        self.held = 0

    def __call__(self):
        return time.perf_counter()


def _tracker_calls(outs, yielded, cams):
    """{stream: [(input boxes, [(box, track id)])]} of every tracker
    call, from the results: a frame's input is its kept detections, its
    output the tracked faces ``MultiStreamPerception`` yielded for it."""
    calls = {c: [] for c in range(cams)}
    for (out, _), results in zip(outs, yielded):
        for slot, r in enumerate(results):
            keep = np.asarray(out["mask"][slot])
            calls[r["stream"]].append((
                list(np.asarray(out["boxes"][slot])[keep]),
                [(f["bbox"], f["track"]) for f in r["faces"]]))
    return calls


def run(ctx):
    from terran_tpu_torch.io.streams import MultiStreamPerception
    from terran_tpu_torch.io.video import EndOfVideo

    mix, cfg = ctx.cell.mix, ctx.cell.pipe_cfg
    h, w = mix["frame"]
    cams, b = mix["cameras"], mix["batch"]
    rate = ctx.rate if ctx.rate is not None else mix["rate_fps"]
    per_cam = rate / cams
    pools = [cellmod.make_frames(ctx.seed, mix["pool"], h, w, ctx.device,
                                 stream=c) for c in range(cams)]
    pipe = ctx.build_pipeline()
    recorder = cellmod.PeakRecorder().install()
    warm = np.stack([pools[i % cams][(i // cams) % mix["pool"]]
                     for i in range(b)])
    cellmod.warm_up(pipe, warm, cfg["depth"])

    sources = [PacedSource(pools[c], per_cam,
                           offset=c * mix["stagger"] / per_cam,
                           end_error=EndOfVideo) for c in range(cams)]
    _warm_streams(pipe, sources, b)
    msp = MultiStreamPerception(pipe, sources, batch_size=b, track=True)
    clock = _Clock()
    for tracker in msp.trackers:
        _time_tracker(tracker, clock)
    outs = _record_outputs(pipe, recorder)
    ctx.setup_done(pipe)
    ctx.tracer.watch(track_s=lambda: clock.track_s)
    recorder.tables.clear()
    t0 = time.perf_counter() + mix["lead_s"]
    end = t0 + ctx.seconds
    for source in sources:
        source.schedule(t0, end)
    ctx.window_opened(t0)
    latencies, dues, yields, yielded = [], [], [], []
    for frame_results in msp:
        t = time.perf_counter()
        yields.append(t)
        yielded.append(frame_results)
        ctx.done.batches += 1
        ctx.done.frames += len(frame_results)
        for r in frame_results:
            dues.append(sources[r["stream"]].due(r["frame"]))
            latencies.append(t - dues[-1])
        ctx.tracer.step(t)
    ctx.tracer.close()
    ctx.window_closed(len(latencies), None)

    due = sum(len(s.taken) for s in sources)
    metas = [[(r["stream"], r["frame"]) for r in results]
             for results in yielded]
    fills = [max(sources[s].taken[f] for s, f in meta)
             - min(sources[s].due(f) for s, f in meta) for meta in metas]
    calls = _tracker_calls(outs, yielded, cams)
    ctx.layer["track_s"] = clock.track_s
    ctx.layer["batches"] = len(metas)
    # The median batch yielded before the first profiled span: a span's
    # stall leaves a backlog that lasts through much of the window after
    # it, and is the tracing's, not the stream's.
    first = ctx.tracer.first_span
    steady = [f for f, t in zip(fills, yields)
              if first is None or t < first]
    ctx.layer["batch_fill_ms"] = (1e3 * percentile(steady, 50) if steady
                                  else None)
    late = [x for s in sources for x in s.lateness()]
    ctx.extra.update({
        "rate_fps": rate, "per_camera_fps": per_cam,
        "source_late_p95_ms": 1e3 * percentile(late, 95),
        "source_late_max_ms": 1e3 * max(late),
        "source_late_last_s_ms": 1e3 * max(
            (x for s in sources for x, t in zip(s.lateness(), s.taken)
             if t > end - 1.0), default=0.0),
        "frame_max_ms": 1e3 * max(latencies),
        "batch_interval_ms": 1e3 * (yields[-1] - yields[0])
        / max(1, len(yields) - 1),
        "track_ms_per_batch": 1e3 * clock.track_s / max(1, len(metas)),
        "faces_per_frame": sum(len(i) for c in calls.values()
                               for i, _ in c) / max(1, len(latencies)),
        "tracks_held_per_frame": clock.held / max(1, len(latencies)),
        "frame_p50_first_third_ms": _p50_ms(
            [x for x, d in zip(latencies, dues)
             if d < t0 + ctx.seconds / 3]),
        "frame_p50_last_third_ms": _p50_ms(
            [x for x, d in zip(latencies, dues)
             if d >= t0 + 2 * ctx.seconds / 3])})

    pick = random.Random(ctx.seed).sample(range(len(metas)),
                                          min(mix["sample_batches"],
                                              len(metas)))
    items = []
    for k in sorted(pick):
        out, peaks = outs[k]
        frames = np.stack([pools[s][f % len(pools[s])] for s, f in metas[k]])
        items.append((frames, cellmod.outputs_of(peaks, out)[:len(frames)]))
    tracks = {"calls": calls, "max_age": int(per_cam),
              "min_hits": int(per_cam) // 5}
    return {"attempted": due, "failed": due - len(latencies),
            "metrics": {"frame_p50_ms": 1e3 * percentile(latencies, 50),
                        "frame_p95_ms": 1e3 * percentile(latencies, 95)},
            "items": items, "tracks": tracks}
