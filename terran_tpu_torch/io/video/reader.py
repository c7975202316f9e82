"""Background-prefetch video reader over an ffmpeg subprocess, a copy of
``terran_tpu/io/video/reader.py``.

Commands are built directly (no ffmpeg-python). Reader-thread exceptions
propagate to the consumer; a nonzero decoder exit is a failure, not an
end of video; the end and failures are sticky; ``close()`` can kill a
decoder blocked on a stalled live source. The decoded batches are
C-contiguous uint8 NHWC arrays, ready for ``torch.from_numpy`` (see
``prefetch.py`` for the uploads).

The same surface as the JAX package's reader: batching,
``framerate``/``read_for``/``start_time`` options, stream/webcam probing
knobs, iterator protocol, ``__len__`` in batches, this package's
``EndOfVideo``/``VideoClosed`` exceptions. YouTube-DL URL resolution is
supported when ``youtube_dl`` is installed; it is imported only then.
"""

import json
import math
import os
import subprocess
from queue import Empty as QueueEmpty, Full as QueueFull, Queue
from threading import Event, Thread

from terran_tpu_torch.io.video import EndOfVideo, VideoClosed


def youtube_dl_available():
    try:
        import youtube_dl  # noqa
        return True
    except ImportError:
        return False


def ffmpeg_available():
    from shutil import which
    return which("ffmpeg") is not None and which("ffprobe") is not None


class FFmpegError(RuntimeError):
    pass


def ffmpeg_probe(path, **kwargs):
    """Run ffprobe and return parsed JSON metadata (ref reader.py:23-66)."""
    if not is_path_stream(path):
        path = os.path.expanduser(path)

    additional_args = []
    for key, value in kwargs.items():
        if not key.startswith("-"):
            key = f"-{key}"
        additional_args.extend([key, str(value)])

    args = [
        "ffprobe", *additional_args, "-show_format", "-show_streams",
        "-of", "json", str(path),
    ]
    try:
        proc = subprocess.Popen(
            args, stdout=subprocess.PIPE, stderr=subprocess.PIPE
        )
    except FileNotFoundError:
        raise FFmpegError(
            "ffprobe binary not found; install ffmpeg to read real videos "
            "(SyntheticVideo works without it)"
        )
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise FFmpegError(f"ffprobe failed for {path}: {err.decode()[-500:]}")
    return json.loads(out.decode("utf-8"))


def parse_video_probe(probe, path):
    """Extract (width, height, source_framerate, source_duration) from an
    ffprobe JSON blob. Shared by ``Video`` and ``ParallelVideo`` — the
    stream selection, avg_frame_rate fraction parsing, and duration
    fallbacks must stay identical between the serial and parallel
    readers. Raises ValueError when no video stream exists;
    ``source_duration`` is None when the container reports none (live
    sources)."""
    video_stream = next(
        (s for s in probe["streams"] if s.get("codec_type") == "video"),
        None,
    )
    if not video_stream:
        raise ValueError(
            f"No video stream found at `{path}`. Are you sure this is a "
            "video file or stream?"
        )
    width = int(video_stream["width"])
    height = int(video_stream["height"])
    # avg_frame_rate is robust against multi-stream containers
    # (ref reader.py:280-287).
    rate = video_stream["avg_frame_rate"]
    if "/" in rate:
        num, den = map(int, rate.split("/"))
        framerate = num / den if den else 0.0
    else:
        framerate = float(rate)
    duration = None
    if "duration" in video_stream:
        duration = float(video_stream["duration"])
    elif "duration" in probe.get("format", {}):
        duration = float(probe["format"]["duration"])
    return width, height, framerate, duration


def is_path_stream(path):
    return any(
        str(path).startswith(prefix)
        for prefix in ("/dev/", "http://", "https://")
    )


def parse_timestamp(timestamp):
    """HH:MM:SS(.ms) -> seconds (ref reader.py:77-85)."""
    if "." in timestamp:
        timestamp, ms = timestamp.split(".")
        ms = float(f"0.{ms}")
    else:
        ms = 0.0
    hours, minutes, seconds = map(float, timestamp.split(":"))
    return hours * 3600 + minutes * 60 + seconds + ms


def read_batch_from_stream(stream, width, height, batch_size):
    """Read one rgb24 batch from a byte stream; None at EOF.

    Returns (batch_size, H, W, 3) if batching, else (H, W, 3). A short
    read yields a smaller final batch (ref reader.py:88-117).
    """
    import numpy as np

    frame_bytes = width * height * 3
    to_read = frame_bytes * (batch_size if batch_size is not None else 1)
    buffer = stream.read(to_read)
    if not buffer:
        return None
    frames_read = len(buffer) // frame_bytes
    if frames_read == 0:
        return None

    frames = np.frombuffer(buffer[: frames_read * frame_bytes], np.uint8)
    if batch_size is not None:
        return frames.reshape([frames_read, height, width, 3])
    return frames.reshape([height, width, 3])


def _frame_reader(queue, should_stop, cmd, spec, proc_holder=None):
    """Reader-thread worker: ffmpeg subprocess -> bounded queue.

    Termination contract: always enqueues a final sentinel — ``None`` for
    clean EOF or the exception itself on failure — so the consumer never
    blocks forever (improvement over ref reader.py:126-162). A stdout
    EOF with a NONZERO ffmpeg exit code is a decode FAILURE, not an end
    of video: it surfaces as an ``FFmpegError`` carrying the stderr tail
    instead of silently truncating the stream (stderr goes to a temp
    file — piping it could deadlock a chatty encoder mid-decode).
    ``proc_holder`` (a one-slot list) exposes the subprocess so
    ``close()`` can kill it when this thread is blocked in a read on a
    stalled live source.
    """
    import tempfile

    proc = None
    stderr_f = tempfile.TemporaryFile()
    try:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=stderr_f
        )
        if proc_holder is not None:
            proc_holder[0] = proc
        while True:
            frames = read_batch_from_stream(
                proc.stdout, spec["width"], spec["height"], spec["batch_size"]
            )
            if frames is None:
                break
            while True:
                if should_stop.is_set():
                    return
                try:
                    queue.put(frames, timeout=0.5)
                    break
                except QueueFull:
                    continue
        returncode = proc.wait()
        if returncode != 0 and not should_stop.is_set():
            stderr_f.seek(0)
            tail = stderr_f.read()[-500:].decode("utf-8", "replace")
            raise FFmpegError(
                f"ffmpeg exited with code {returncode} mid-decode "
                f"(frames silently lost without this check): {tail}"
            )
        _put_final(queue, should_stop, None)
    except Exception as exc:  # propagate to consumer
        _put_final(queue, should_stop, exc)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
        stderr_f.close()


def _put_final(queue, should_stop, item):
    while not should_stop.is_set():
        try:
            queue.put(item, timeout=0.5)
            return
        except QueueFull:
            continue


class Video:
    """A video file/stream exposed as an iterator of uint8 NHWC batches.

    Same constructor surface as the reference ``Video`` (reader.py:173-213).
    """

    def __init__(self, path, batch_size=None, framerate=None, is_stream=None,
                 read_for=None, start_time=None, ydl_format="best"):
        self.path = os.path.expanduser(str(path))
        self.batch_size = batch_size
        self.read_for = read_for
        self._framerate = framerate
        self.ydl_format = ydl_format

        if isinstance(start_time, str):
            start_time = parse_timestamp(start_time)
        self.start_time = start_time

        self.is_stream = is_stream if is_stream else is_path_stream(self.path)

        try:
            if self.is_stream:
                self.stream_path = self._get_stream_path()
                probe = ffmpeg_probe(
                    self.stream_path,
                    probesize=20 * 1024 * 1024,
                    analyzeduration=10 * 1000 * 1000,
                )
            else:
                probe = ffmpeg_probe(self.path)
        except FFmpegError:
            message = f"Video at `{path}` not found. Are you sure it exists?"
            if not youtube_dl_available():
                message += (
                    "\n\nUnable to find suitable way to stream from online "
                    "video platforms. If you're trying to stream from "
                    "YouTube or other streaming platforms, make sure "
                    "`youtube-dl` is installed first. If not, ignore this "
                    "message."
                )
            raise ValueError(message)

        (self.width, self.height, self.source_framerate,
         self.source_duration) = parse_video_probe(probe, path)

        if self.duration is not None and self.duration < 0:
            raise ValueError(
                "Duration of the video is negative. Is the `start_time` "
                "timestamp after the video ends?"
            )

        self._thread = None
        self._queue = None
        self._stop_signal = None
        self._closed = False
        self._proc_holder = [None]  # lets close() kill a blocked decode
        self._final = None  # EOF/error sentinel, re-delivered on re-read

    # -- context manager / iterator protocol --------------------------------

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
        """Number of batches (ref reader.py:328-346)."""
        if not self.duration:
            raise AttributeError(
                "Video doesn't have a duration. Is it a stream?"
            )
        batch_size = self.batch_size if self.batch_size else 1
        return math.ceil(
            math.ceil(self.duration * self.framerate) / batch_size
        )

    @property
    def framerate(self):
        return (
            self._framerate if self._framerate is not None
            else self.source_framerate
        )

    @property
    def duration(self):
        if not self.source_duration:
            return self.read_for
        source_duration = (
            self.source_duration if not self.start_time
            else self.source_duration - self.start_time
        )
        if self.read_for:
            return min(source_duration, self.read_for)
        return source_duration

    # -- internals -----------------------------------------------------------

    def _get_stream_path(self):
        """YouTube-DL URL resolution when available (ref reader.py:388-419)."""
        if not youtube_dl_available():
            return self.path

        import youtube_dl

        ydl_options = {
            "format": self.ydl_format, "quiet": True, "no_warnings": True,
        }
        for extractor in youtube_dl.gen_extractors():
            if extractor.suitable(self.path):
                try:
                    with youtube_dl.YoutubeDL(ydl_options) as ydl:
                        info = ydl.extract_info(self.path, download=False)
                        self.ydl_info = info
                        if info["url"] is None:
                            raise ValueError(
                                "Unable to find stream URL for video format "
                                f"{self.ydl_format}"
                            )
                        return info["url"]
                except youtube_dl.utils.YoutubeDLError:
                    break
        return self.path

    def _prepare_ffmpeg_cmd(self):
        """Build the decode command (ref reader.py:421-465), directly as an
        argv list instead of via ffmpeg-python."""
        cmd = ["ffmpeg", "-err_detect", "ignore_err"]

        if self.is_stream:
            cmd += [
                "-probesize", str(20 * 1024 * 1024),
                "-analyzeduration", str(10 * 1000 * 1000),
            ]
        if self.start_time or self.is_stream:
            cmd += ["-ss", str(self.start_time or "00:00:05")]
        if self.duration is not None:
            cmd += ["-t", str(self.duration)]

        input_path = self.stream_path if self.is_stream else self.path
        cmd += ["-i", input_path]

        if self._framerate:
            cmd += ["-r", str(self._framerate)]
        cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:"]
        return cmd

    def read_frames(self):
        """Blocking read of the next batch; raises ``EndOfVideo`` at the end
        and re-raises reader-thread failures here (ref reader.py:467-501).
        The final sentinel is remembered: reading again after the end (or
        after an error) re-raises instead of blocking forever on the
        empty queue of a finished producer."""
        if self._closed:
            raise EndOfVideo
        if self._final is not None:
            raise self._final

        if not self._thread:
            cmd = self._prepare_ffmpeg_cmd()
            spec = {
                "width": self.width,
                "height": self.height,
                "batch_size": self.batch_size,
            }
            from terran_tpu_torch.config import get_config

            self._queue = Queue(get_config().reader_buffer_batches)
            self._stop_signal = Event()
            self._thread = Thread(
                args=(self._queue, self._stop_signal, cmd, spec,
                      self._proc_holder),
                name="FrameReader",
                target=_frame_reader,
                daemon=True,
            )
            self._thread.start()

        item = self._queue.get()
        if item is None:
            self._final = EndOfVideo()
            raise self._final
        if isinstance(item, Exception):
            self._final = item
            raise item
        return item

    def close(self):
        if self._closed:
            raise VideoClosed("The video has already been closed.")
        self._closed = True
        if self._thread:
            self._stop_signal.set()
            # Drain so a blocked producer can observe the stop signal.
            try:
                while True:
                    self._queue.get_nowait()
            except QueueEmpty:
                pass
            # A thread blocked inside proc.stdout.read() on a stalled
            # live source never reaches the stop check; kill the decoder
            # to force an EOF rather than joining forever.
            self._thread.join(timeout=2.0)
            if self._thread.is_alive():
                proc = self._proc_holder[0]
                if proc is not None and proc.poll() is None:
                    proc.kill()
                self._thread.join()
            # Wake any consumer blocked in read_frames() with the EOF
            # sentinel (the queue was just drained, so this cannot block).
            try:
                self._queue.put_nowait(None)
            except QueueFull:  # pragma: no cover
                pass


def open_video(*args, **kwargs):
    """Open a video file, stream, or capture device (ref reader.py:516-530)."""
    return Video(*args, **kwargs)
