"""Background video writer over an ffmpeg subprocess, a copy of
``terran_tpu/io/video/writer.py``.

Frames — or deferred ``(render_fn, *args)`` pairs executed in the writer
thread, overlapping rendering with device compute; ``render_fn`` is any
callable — are queued and piped to an ffmpeg encode process as rawvideo
rgb24, emitted as yuv420p.
"""

import os
import subprocess
from queue import Queue
from threading import Thread

from terran_tpu_torch.io.video import VideoClosed


def _frame_writer(queue, cmd, error_sink, drain_timeout):
    try:
        proc = subprocess.Popen(
            cmd,
            stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        while True:
            item = queue.get()
            if item is None:
                break
            frame_or_func, *args = item
            frame = (
                frame_or_func(*args) if callable(frame_or_func)
                else frame_or_func
            )
            proc.stdin.write(frame.tobytes())

        proc.stdin.close()
        # Let the encoder drain stdin and finalise the container before
        # escalating (the reference terminates immediately, writer.py:36-40,
        # which can truncate the tail of the file). Escalation truncates
        # too, so it must never be silent: a loaded machine was once
        # observed taking >10 s just to START the encoder process, which
        # a fixed quiet timeout turned into a zero-byte output.
        try:
            proc.wait(timeout=drain_timeout)
        except subprocess.TimeoutExpired:
            from terran_tpu_torch.utils.profiling import get_logger

            get_logger().warning(
                "encoder still running %.0f s after final frame; "
                "terminating — output may be truncated (raise "
                "TERRAN_TPU_WRITER_DRAIN_TIMEOUT_S for slow encodes)",
                drain_timeout,
            )
            proc.terminate()
            try:
                proc.wait(timeout=drain_timeout)
            except subprocess.TimeoutExpired:
                # An encoder that ignores SIGTERM must not survive
                # close() as an orphan (nor turn the timeout into an
                # error that buries the truncation warning): force-kill
                # and reap it.
                get_logger().warning(
                    "encoder ignored SIGTERM %.0f s after terminate; "
                    "killing", drain_timeout,
                )
                proc.kill()
                proc.wait()
    except Exception as exc:  # surfaced on close()
        error_sink.append(exc)


class VideoWriter:
    """Same construction surface as the reference (writer.py:43-88):
    ``framerate`` / ``copy_format_from`` / ``size_hint``."""

    def __init__(self, output_path, framerate=None, copy_format_from=None,
                 size_hint=None, **kwargs):
        self.output_path = os.path.expanduser(str(output_path))

        if framerate is None and copy_format_from is None:
            self.framerate = 30
        elif framerate is None:
            # Duck-typed: any reader with a framerate (Video, ParallelVideo,
            # SyntheticVideo); a path/URL is opened to probe it.
            if not hasattr(copy_format_from, "framerate"):
                from terran_tpu_torch.io.video.reader import open_video

                copy_format_from = open_video(copy_format_from)
            self.framerate = copy_format_from.framerate
        else:
            self.framerate = framerate

        self.size_hint = size_hint
        self._thread = None
        self._queue = None
        self._errors = []
        self._closed = False

    def __del__(self):
        if not getattr(self, "_closed", True):
            self.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def _prepare_ffmpeg_cmd(self):
        return [
            "ffmpeg",
            "-framerate", str(self.framerate),
            "-f", "rawvideo",
            "-pix_fmt", "rgb24",
            "-s", f"{self.width}x{self.height}",
            "-i", "pipe:",
            "-pix_fmt", "yuv420p",
            "-y", self.output_path,
        ]

    def write_frame(self, frame_or_func, *args):
        """Queue a frame, or a render function + args to be executed in the
        writer thread (ref writer.py:122-156)."""
        if self._closed:
            raise VideoClosed("The video has already been closed.")

        if not self._thread:
            if not self.size_hint:
                frame = (
                    frame_or_func(*args) if callable(frame_or_func)
                    else frame_or_func
                )
                self.height, self.width = frame.shape[0:2]
            else:
                self.height, self.width = self.size_hint

            cmd = self._prepare_ffmpeg_cmd()
            from terran_tpu_torch.config import get_config

            cfg = get_config()
            self._queue = Queue(cfg.writer_buffer_frames)
            # daemon: a producer that crashes without close() leaves this
            # thread blocked in queue.get() forever; a non-daemon thread
            # would then hang interpreter shutdown. The output file is
            # already unfinalised in that scenario (only close() drains
            # and finalises the container), so the daemon flag loses
            # nothing — the reference left this as an open TODO
            # (writer.py:41 "Daemon or not?").
            self._thread = Thread(
                target=_frame_writer,
                args=(self._queue, cmd, self._errors,
                      cfg.writer_drain_timeout_s),
                daemon=True,
            )
            self._thread.start()

        # A dead writer thread (encoder failed to start or exited early)
        # stops draining the bounded queue; blocking puts would deadlock the
        # producer and bury the recorded error. Poll so the failure surfaces.
        # The writer is NOT marked closed here: the with-block's close()
        # must still run (join the thread, re-raise the same recorded
        # error) instead of hitting the already-closed guard and masking
        # the encoder failure with a VideoClosed.
        from queue import Full as QueueFull

        while True:
            if self._errors:
                raise self._errors[0]
            try:
                self._queue.put((frame_or_func, *args), timeout=0.5)
                return
            except QueueFull:
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "video writer thread exited unexpectedly"
                    )

    def close(self):
        if self._closed:
            raise VideoClosed("The video has already been closed.")
        self._closed = True
        if self._thread:
            from queue import Empty as QueueEmpty, Full as QueueFull

            # Block until the sentinel is queued while the encoder is
            # alive — a slow encoder (4K, slow disk) may take >1 s per
            # slot, and every queued frame must still reach it. Only a
            # DEAD thread justifies dropping frames (it stopped draining;
            # blocking would deadlock and bury the recorded error).
            while True:
                try:
                    self._queue.put(None, timeout=0.5)
                    break
                except QueueFull:
                    if not self._thread.is_alive():
                        # Thread is gone; drop queued frames so join
                        # can't hang (the error is re-raised below).
                        try:
                            while True:
                                self._queue.get_nowait()
                        except QueueEmpty:
                            pass
                        break
            self._thread.join()
        if self._errors:
            raise self._errors[0]


def write_video(*args, **kwargs):
    """Create a ``VideoWriter`` (ref writer.py:168-180)."""
    return VideoWriter(*args, **kwargs)
