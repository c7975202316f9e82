"""Multi-process decode fan-in for a single high-rate source, a copy of
``terran_tpu/io/video/parallel.py``.

The serial reader decodes a source with one ffmpeg subprocess behind one
reader thread, so a single high-fps/high-resolution file caps the whole
pipeline at one decoder's throughput.

``ParallelVideo`` splits a seekable source into fixed time segments and
decodes ``workers`` segments concurrently, each in its own ffmpeg
subprocess (seeked with ``-ss``/bounded with ``-t``), fanning the batches
back to the consumer in exact source order:

- Workers claim segment indices from a shared counter, gated by a sliding
  window over the consumer position so decode-ahead (and therefore memory)
  stays bounded.
- Each segment streams through its own small bounded queue; the consumer
  drains segment *i* to its EOF sentinel before moving to segment *i+1*.
- Worker exceptions are delivered in-order through the owning segment's
  queue and re-raised in ``read_frames``.

Caveats (documented, inherent to container seeking): segment boundaries
land on ffmpeg's ``-ss`` seek points, so frame counts can differ by ±1 at
boundaries versus the serial reader, and batches never span segments (the
last batch of a segment may be short). Live streams and sources without a
known duration are rejected — use
:class:`terran_tpu_torch.io.video.reader.Video` for those.
"""

import math
import subprocess
from itertools import count
from queue import Empty as QueueEmpty, Full as QueueFull, Queue
from threading import Condition, Event, Thread

from terran_tpu_torch.io.video import EndOfVideo, VideoClosed
from terran_tpu_torch.io.video import reader as reader_mod


class ParallelVideo:
    """A seekable video decoded by a pool of ffmpeg subprocesses.

    Same iterator/contract surface as ``Video``: yields uint8 NHWC batches
    in source order, raises ``EndOfVideo`` when exhausted.

    Parameters
    ----------
    path : source file path (must be seekable with a known duration).
    workers : concurrent decoder subprocesses (>= 1).
    batch_size : frames per yielded batch (None -> single frames).
    segment_time : seconds of video per decode segment (default: enough
        for ~4 batches, at least 1 second).
    window : segments a worker may run ahead of the consumer (default
        ``workers + 1``); bounds decode-ahead memory together with the
        per-segment queue of 2 batches.
    """

    def __init__(self, path, workers=2, batch_size=None, framerate=None,
                 read_for=None, start_time=None, segment_time=None,
                 window=None):
        import os

        self.path = os.path.expanduser(str(path))
        if reader_mod.is_path_stream(self.path):
            raise ValueError(
                "ParallelVideo needs a seekable source; streams must use "
                "the serial Video reader."
            )
        self.batch_size = batch_size
        self._framerate = framerate

        if isinstance(start_time, str):
            start_time = reader_mod.parse_timestamp(start_time)
        self.start_time = start_time or 0.0

        probe = reader_mod.ffmpeg_probe(self.path)
        (self.width, self.height, self.source_framerate,
         source_duration) = reader_mod.parse_video_probe(probe, path)
        if source_duration is None:
            raise ValueError(
                "ParallelVideo needs a known duration to place segment "
                "seeks; this source reports none."
            )

        duration = source_duration - self.start_time
        if read_for is not None:
            duration = min(duration, read_for)
        if duration <= 0:
            raise ValueError(
                "Duration of the video is negative. Is the `start_time` "
                "timestamp after the video ends?"
            )
        self.duration = duration

        if segment_time is None:
            per_batch = (batch_size or 1) / max(self.framerate, 1e-6)
            segment_time = max(4 * per_batch, 1.0)
        self.segment_time = float(segment_time)

        n_segments = max(1, math.ceil(self.duration / self.segment_time))
        self.segments = []
        for i in range(n_segments):
            seg_start = self.start_time + i * self.segment_time
            seg_dur = min(
                self.segment_time,
                self.start_time + self.duration - seg_start,
            )
            self.segments.append((seg_start, seg_dur))

        self.workers = max(1, int(workers))
        self.window = self.workers + 1 if window is None else max(1, window)

        self._cond = Condition()
        self._queues = {}        # segment index -> Queue of batches
        self._next_emit = 0      # segment the consumer is draining
        self._claims = count()   # shared segment counter for workers
        self._threads = []
        self._stop = Event()
        self._closed = False
        self._shut = False       # internal wind-down ran (idempotent)
        self._final = None       # terminal decode error, re-delivered
        self._live_procs = set()  # decoders close() may need to kill

    # -- contract surface (mirrors Video) -----------------------------------

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self.read_frames()
        except EndOfVideo:
            raise StopIteration

    def __del__(self):
        if not getattr(self, "_closed", True):
            self.close()

    def __len__(self):
        batch = self.batch_size or 1
        return math.ceil(math.ceil(self.duration * self.framerate) / batch)

    @property
    def framerate(self):
        return (
            self._framerate if self._framerate is not None
            else self.source_framerate
        )

    # -- decoding ------------------------------------------------------------

    def _prepare_segment_cmd(self, seg_start, seg_duration):
        """Decode command for one segment (tests monkeypatch this with a
        deterministic frame emitter, like test_io does for Video)."""
        cmd = ["ffmpeg", "-err_detect", "ignore_err",
               "-ss", str(seg_start), "-t", str(seg_duration),
               "-i", self.path]
        if self._framerate:
            cmd += ["-r", str(self._framerate)]
        cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:"]
        return cmd

    def _claim(self):
        """Next segment index this worker may decode, gated by the window;
        None when the video is exhausted or closing."""
        with self._cond:
            while True:
                if self._stop.is_set():
                    return None
                index = next(self._claims)
                if index >= len(self.segments):
                    return None
                while (
                    index >= self._next_emit + self.window
                    and not self._stop.is_set()
                ):
                    self._cond.wait(timeout=0.5)
                if self._stop.is_set():
                    return None
                self._queues[index] = Queue(maxsize=2)
                self._cond.notify_all()
                return index

    def _decode_segment(self, index, queue):
        seg_start, seg_dur = self.segments[index]
        import tempfile

        proc = None
        stderr_f = tempfile.TemporaryFile()
        try:
            proc = subprocess.Popen(
                self._prepare_segment_cmd(seg_start, seg_dur),
                stdout=subprocess.PIPE, stderr=stderr_f,
            )
            self._live_procs.add(proc)
            while not self._stop.is_set():
                frames = reader_mod.read_batch_from_stream(
                    proc.stdout, self.width, self.height, self.batch_size
                )
                if frames is None:
                    break
                self._offer(queue, frames)
            # A stdout EOF with a nonzero exit code is a FAILED segment,
            # not a finished one: without this check a crashed decode
            # was indistinguishable from clean EOF and a mid-video chunk
            # of frames vanished silently, corrupting provenance for
            # every downstream consumer.
            if not self._stop.is_set():
                returncode = proc.wait()
                if returncode != 0:
                    stderr_f.seek(0)
                    tail = stderr_f.read()[-500:].decode("utf-8", "replace")
                    raise reader_mod.FFmpegError(
                        f"ffmpeg exited with code {returncode} on segment "
                        f"{index} (t={seg_start:.2f}s, {seg_dur:.2f}s): "
                        f"{tail}"
                    )
            self._offer(queue, None)
        except Exception as exc:
            self._offer(queue, exc)
        finally:
            if proc is not None:
                if proc.poll() is None:
                    proc.kill()
                self._live_procs.discard(proc)
            stderr_f.close()

    def _offer(self, queue, item):
        """Bounded put that gives up when the consumer is closing."""
        while not self._stop.is_set():
            try:
                queue.put(item, timeout=0.5)
                return
            except QueueFull:
                continue

    def _worker(self):
        while True:
            index = self._claim()
            if index is None:
                return
            self._decode_segment(index, self._queues[index])

    def _ensure_started(self):
        if self._threads:
            return
        for i in range(self.workers):
            thread = Thread(
                target=self._worker, name=f"ParallelDecoder-{i}", daemon=True
            )
            thread.start()
            self._threads.append(thread)

    def read_frames(self):
        """Next batch in source order; ``EndOfVideo`` when exhausted."""
        if self._closed:
            raise EndOfVideo
        if self._final is not None:
            raise self._final
        self._ensure_started()

        while True:
            if self._next_emit >= len(self.segments):
                raise EndOfVideo

            with self._cond:
                while (
                    self._next_emit not in self._queues
                    and not self._stop.is_set()
                ):
                    self._cond.wait(timeout=0.5)
                queue = self._queues.get(self._next_emit)
            if queue is None:  # closed while waiting
                raise EndOfVideo

            while True:
                try:
                    item = queue.get(timeout=0.5)
                    break
                except QueueEmpty:
                    if self._stop.is_set():
                        raise EndOfVideo
            if isinstance(item, Exception):
                # Decode errors are terminal, like the single-process
                # reader's: the failed segment has no further producer, so
                # a retrying caller would otherwise block forever on its
                # queue. The INTERNAL shutdown winds the workers down
                # without flipping the public closed flag — a with-block's
                # __exit__ (or user close()) must still run normally
                # instead of raising VideoClosed over the actual decode
                # error; _final re-delivers it on any further read.
                self._shutdown()
                self._final = item
                raise item
            if item is None:
                # Segment exhausted: advance and let workers claim further.
                with self._cond:
                    del self._queues[self._next_emit]
                    self._next_emit += 1
                    self._cond.notify_all()
                continue
            return item

    def _shutdown(self):
        """Idempotent worker wind-down (shared by ``close()`` and the
        terminal-error path in ``read_frames``)."""
        if self._shut:
            return
        self._shut = True
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        # Drain so blocked producers observe the stop signal.
        for queue in list(self._queues.values()):
            try:
                while True:
                    queue.get_nowait()
            except QueueEmpty:
                pass
        # A worker blocked inside proc.stdout.read() never reaches its
        # stop check; kill the decoders to force EOFs rather than
        # joining forever.
        deadline_joined = True
        for thread in self._threads:
            thread.join(timeout=2.0)
            if thread.is_alive():
                deadline_joined = False
        if not deadline_joined:
            for proc in list(self._live_procs):
                if proc.poll() is None:
                    proc.kill()
            for thread in self._threads:
                thread.join()

    def close(self):
        if self._closed:
            raise VideoClosed("The video has already been closed.")
        self._closed = True
        self._shutdown()


def open_video_parallel(*args, **kwargs):
    """Open a seekable video with the multi-process decoder."""
    return ParallelVideo(*args, **kwargs)
