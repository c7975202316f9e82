"""Multi-stream scheduling: batch frames from concurrent videos.

A copy of ``terran_tpu/io/streams.py`` on this package's
``PerceptionPipeline`` and ``Sort``. The pipeline wants one fixed-shape
batch per step, so the scheduler round-robins frames from N sources into
(batch, H, W, 3) arrays, tracks (stream, frame_index) provenance for
demuxing results, and keeps per-stream tracker state. Sources are
anything with the ``Video`` iterator protocol that raises this package's
``EndOfVideo`` (``Video``, ``SyntheticVideo``); exhausted streams drop out
of rotation and the final partial batch is flushed.
"""

import time
from collections import deque

import numpy as np

from terran_tpu_torch.io.video import EndOfVideo
from terran_tpu_torch.utils.profiling import profiler_range


class StreamMultiplexer:
    """Round-robin frames of same-resolution streams into fixed batches.

    Yields ``(frames, meta)`` where frames is (n, H, W, 3) uint8 and meta is
    a list of (stream_index, frame_index) pairs, n <= batch_size (smaller
    only on the final flush).
    """

    def __init__(self, streams, batch_size=8):
        self.streams = list(streams)
        self.batch_size = batch_size
        self._frame_counters = [0] * len(self.streams)
        # Per-stream pending frames (sources may emit batches themselves).
        self._pending = [deque() for _ in self.streams]
        self._active = set(range(len(self.streams)))

    def _pull(self, idx):
        """Refill pending frames for one stream; False when exhausted."""
        if self._pending[idx]:
            return True
        try:
            frames = self.streams[idx].read_frames()
        except (EndOfVideo, StopIteration):
            return False
        if frames.ndim == 3:
            frames = frames[None]
        for frame in frames:
            self._pending[idx].append(frame)
        return len(self._pending[idx]) > 0

    def __iter__(self):
        batch, meta = [], []
        while self._active:
            # An iteration that makes no progress discarded every stream
            # from _active, so the while condition ends the loop.
            for idx in sorted(self._active):
                if not self._pull(idx):
                    self._active.discard(idx)
                    continue
                batch.append(self._pending[idx].popleft())
                meta.append((idx, self._frame_counters[idx]))
                self._frame_counters[idx] += 1
                if len(batch) == self.batch_size:
                    yield np.stack(batch), meta
                    batch, meta = [], []
        if batch:
            yield np.stack(batch), meta


class MultiStreamPerception:
    """Concurrent-stream perception: multiplexed batches through the
    pipeline, per-stream SORT tracking, demuxed per-stream results."""

    def __init__(self, pipeline, streams, batch_size=8, track=True,
                 min_hits=None, max_age=None):
        from terran_tpu_torch.tracking.face import Sort

        self.pipeline = pipeline
        self.mux = StreamMultiplexer(streams, batch_size=batch_size)
        self.track = track
        if track:
            # Each stream's own framerate sets its eviction window, read
            # from the multiplexer's materialised list so generator inputs
            # work too.
            self.trackers = []
            for stream in self.mux.streams:
                framerate = getattr(stream, "framerate", 30) or 30
                self.trackers.append(Sort(
                    max_age=(
                        max_age if max_age is not None else int(framerate)
                    ),
                    min_hits=(
                        min_hits if min_hits is not None
                        else int(framerate) // 5
                    ),
                ))

    def __iter__(self):
        """Yield per-batch lists of result dicts:
        {stream, frame, faces, embeddings, pose}.

        Rides ``PerceptionPipeline.process_stream`` (config
        ``pipeline_depth``, two-phase finalization, uploads on a thread).
        Metas travel in a lockstep FIFO: process_stream consumes batches in
        order and yields results in order, and the deque's append/popleft
        are atomic, so pairing holds even with the upload thread pulling
        the generator ahead of the dispatch loop.
        """
        metas = deque()

        def padded_batches():
            for frames, meta in self.mux:
                # Pad trailing partial batches to the fixed batch size so
                # every batch runs at one shape.
                if frames.shape[0] < self.mux.batch_size:
                    pad = self.mux.batch_size - frames.shape[0]
                    frames = np.concatenate(
                        [frames, np.repeat(frames[-1:], pad, axis=0)]
                    )
                metas.append(meta)
                yield frames

        for out in self.pipeline.process_stream(padded_batches()):
            yield self._results(out, metas.popleft())

    def _results(self, out, meta):
        faces_per_frame = self.pipeline.faces_from(out)
        if self.track:
            faces_per_frame = self._tracked(faces_per_frame, meta)
        results = []
        for slot, (stream_idx, frame_idx) in enumerate(meta):
            faces = faces_per_frame[slot]
            results.append({
                "stream": stream_idx,
                "frame": frame_idx,
                "faces": faces,
                "embeddings": (
                    out["embeddings"][slot][out["embeddings_mask"][slot]]
                    if "embeddings" in out else None
                ),
                "pose": out["poses"][slot] if "poses" in out else None,
            })
        return results

    def _tracked(self, faces_per_frame, meta):
        """Each frame's faces through its stream's tracker, in order, inside
        one ``terran::track`` profiler range. With a ``StageTimer`` on the
        pipeline (its ``timer``), the batch's ``update`` calls record one
        ``track`` stage, items the frames."""
        timer = getattr(self.pipeline, "timer", None)
        clock = time.perf_counter if timer is not None else lambda: 0.0
        tracked, seconds = [], 0.0
        with profiler_range("terran::track"):
            for faces, (stream_idx, _) in zip(faces_per_frame, meta):
                start = clock()
                tracked.append(self.trackers[stream_idx].update(faces))
                seconds += clock() - start
        if timer is not None:
            timer.record("track", seconds, items=len(meta))
        return tracked
