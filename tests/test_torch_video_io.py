"""The port's video I/O (``terran_tpu_torch.io.video``): the video cases
of ``tests/test_io.py``, ``tests/test_parallel_video.py`` and
``tests/test_reader_stress.py`` against the port, driven the same way:
no ffmpeg binary, each 'ffmpeg' a Python process that emits raw frames,
with ``terran_tpu_torch.io.video.reader.ffmpeg_probe`` and the
``_prepare_*_cmd`` methods patched. Then the port's readers against the JAX package's on
the same emitters, and ``SyntheticVideo`` against the JAX one, frame for
frame.
"""

import dataclasses
import logging
import sys
import threading
import time
from io import BytesIO

import numpy as np
import pytest

from terran_tpu.io.video import SyntheticVideo as JaxSyntheticVideo
from terran_tpu.io.video.parallel import ParallelVideo as JaxParallelVideo
from terran_tpu.io.video.reader import Video as JaxVideo
from terran_tpu_torch.config import get_config, set_config
from terran_tpu_torch.io import open_video, write_video
from terran_tpu_torch.io.video import (
    EndOfVideo, SyntheticVideo, VideoClosed, parallel, reader,
)
from terran_tpu_torch.io.video.parallel import ParallelVideo
from terran_tpu_torch.io.video.reader import (
    FFmpegError, Video, parse_timestamp, parse_video_probe,
    read_batch_from_stream,
)
from terran_tpu_torch.io.video.writer import VideoWriter

PROBE = "terran_tpu_torch.io.video.reader.ffmpeg_probe"
JAX_PROBE = "terran_tpu.io.video.reader.ffmpeg_probe"


def python_cmd(code):
    # -S: no site initialisation, so each fake decoder starts fast.
    return [sys.executable, "-S", "-c", code]


def fake_probe(width, height, rate, duration=None):
    stream = {"codec_type": "video", "width": width, "height": height,
              "avg_frame_rate": rate}
    fmt = {}
    if duration is not None:
        stream["duration"] = fmt["duration"] = str(duration)
    return {"streams": [stream], "format": fmt}


FAKE_PROBE = fake_probe(8, 6, "10/1", 2.0)


def emitter(num_frames, width=8, height=6):
    return python_cmd(
        "import sys\n"
        f"n = {width} * {height} * 3 * {num_frames}\n"
        "data = bytes(range(256)) * (n // 256 + 1)\n"
        "sys.stdout.buffer.write(data[:n])\n"
    )


def make_fake_video(monkeypatch, batch_size=4, num_frames=20, cls=Video,
                    probe=PROBE, **kwargs):
    """A ``cls`` whose 'ffmpeg' is a Python process emitting raw frames."""
    monkeypatch.setattr(probe, lambda p, **kw: FAKE_PROBE)
    video = cls("/fake/video.mp4", batch_size=batch_size, **kwargs)
    monkeypatch.setattr(video, "_prepare_ffmpeg_cmd",
                        lambda: emitter(num_frames))
    return video


# tests/test_io.py's video cases.

def test_parse_timestamp():
    assert parse_timestamp("01:02:03") == 3723
    assert parse_timestamp("00:00:05.5") == 5.5


def test_read_batch_from_stream_full_short_empty():
    w, h = 4, 3
    frame = np.arange(w * h * 3, dtype=np.uint8).reshape(h, w, 3)
    stream = BytesIO(frame.tobytes() * 5)
    batch = read_batch_from_stream(stream, w, h, 2)
    assert batch.shape == (2, h, w, 3)
    np.testing.assert_array_equal(batch[0], frame)
    assert read_batch_from_stream(stream, w, h, 2).shape == (2, h, w, 3)
    assert read_batch_from_stream(stream, w, h, 2).shape == (1, h, w, 3)
    assert read_batch_from_stream(stream, w, h, 2) is None
    single = read_batch_from_stream(BytesIO(frame.tobytes()), w, h, None)
    assert single.shape == (h, w, 3)


def test_parse_video_probe():
    assert parse_video_probe(FAKE_PROBE, "x") == (8, 6, 10.0, 2.0)
    assert parse_video_probe(fake_probe(4, 2, "0/0"), "x") == (4, 2, 0.0,
                                                               None)
    with pytest.raises(ValueError, match="No video stream"):
        parse_video_probe({"streams": [{"codec_type": "audio"}]}, "x")


def test_video_reader_end_to_end(monkeypatch):
    video = make_fake_video(monkeypatch, batch_size=4, num_frames=10)
    assert video.width == 8 and video.height == 6
    assert video.framerate == 10
    assert len(video) == 5  # ceil(2.0 s * 10 fps / 4)
    batches = list(video)
    assert [b.shape[0] for b in batches] == [4, 4, 2]
    assert all(b.shape[1:] == (6, 8, 3) for b in batches)
    video.close()


def test_video_reader_close_midstream(monkeypatch):
    video = make_fake_video(monkeypatch, batch_size=2, num_frames=100)
    assert video.read_frames().shape == (2, 6, 8, 3)
    video.close()
    with pytest.raises(EndOfVideo):
        video.read_frames()
    with pytest.raises(VideoClosed):
        video.close()


def test_video_reader_propagates_thread_errors(monkeypatch):
    video = make_fake_video(monkeypatch, batch_size=2)
    monkeypatch.setattr(video, "_prepare_ffmpeg_cmd",
                        lambda: ["/nonexistent-binary-xyz"])
    with pytest.raises(FileNotFoundError):
        video.read_frames()


def test_video_reader_nonzero_exit_is_failure_not_eof(monkeypatch):
    video = make_fake_video(monkeypatch, batch_size=2)
    crash = python_cmd(
        "import sys\n"
        "sys.stdout.buffer.write(bytes(8 * 6 * 3 * 2))\n"
        "sys.stderr.write('simulated crash')\n"
        "sys.exit(5)\n"
    )
    monkeypatch.setattr(video, "_prepare_ffmpeg_cmd", lambda: crash)
    assert video.read_frames().shape == (2, 6, 8, 3)
    with pytest.raises(FFmpegError, match="code 5.*simulated crash"):
        video.read_frames()
    with pytest.raises(FFmpegError):  # sticky
        video.read_frames()


def test_video_reader_eof_is_repeatable(monkeypatch):
    video = make_fake_video(monkeypatch, batch_size=4, num_frames=4)
    video.read_frames()
    for _ in range(2):
        with pytest.raises(EndOfVideo):
            video.read_frames()


def test_video_reader_framerate_and_start_time(monkeypatch):
    video = make_fake_video(monkeypatch, batch_size=2, framerate=5,
                            start_time="00:00:01")
    assert video.framerate == 5
    assert video.duration == 1.0
    cmd = Video._prepare_ffmpeg_cmd(video)  # the instance's is patched
    assert cmd[cmd.index("-ss") + 1] == "1.0"
    assert cmd[cmd.index("-r") + 1] == "5"


def test_video_missing_file_raises_value_error():
    # No ffprobe here: the probe fails and the reader says so.
    with pytest.raises(ValueError, match="not found"):
        open_video("/definitely/not/here.mp4")


def test_video_len_requires_duration(monkeypatch):
    probe = fake_probe(8, 6, "10/1")
    monkeypatch.setattr(PROBE, lambda p, **kw: probe)
    video = Video("/fake/stream.mp4", batch_size=4)
    assert video.duration is None
    with pytest.raises(AttributeError):
        len(video)
    assert len(Video("/fake/stream.mp4", batch_size=4, read_for=2)) == 5


def sink_writer(tmp_path, monkeypatch, **kwargs):
    out_raw = tmp_path / "sink.raw"
    writer = write_video(tmp_path / "out.mp4", framerate=10, **kwargs)
    sink = python_cmd(
        "import sys, shutil\n"
        f"shutil.copyfileobj(sys.stdin.buffer, open(r'{out_raw}', 'wb'))\n"
    )
    monkeypatch.setattr(writer, "_prepare_ffmpeg_cmd", lambda: sink)
    return writer, out_raw


def test_writer_deferred_render(tmp_path, monkeypatch):
    writer, out_raw = sink_writer(tmp_path, monkeypatch)
    frame = np.full((6, 8, 3), 7, np.uint8)
    rendered_in_thread = []

    def render(base, offset):
        rendered_in_thread.append(threading.current_thread())
        return base + offset

    writer.write_frame(frame)
    writer.write_frame(render, frame, 1)
    writer.close()
    got = np.frombuffer(out_raw.read_bytes(), np.uint8).reshape(2, 6, 8, 3)
    np.testing.assert_array_equal(got[0], frame)
    np.testing.assert_array_equal(got[1], frame + 1)
    assert len(rendered_in_thread) == 1
    assert rendered_in_thread[0] is not threading.current_thread()
    with pytest.raises(VideoClosed):
        writer.write_frame(frame)


def test_writer_size_hint_and_copy_format(tmp_path, monkeypatch):
    source = SyntheticVideo(width=8, height=6, framerate=12)
    writer = VideoWriter(tmp_path / "out.mp4", copy_format_from=source,
                         size_hint=(6, 8))
    assert writer.framerate == 12
    assert VideoWriter(tmp_path / "o.mp4").framerate == 30
    out_raw = tmp_path / "sink.raw"
    sink = python_cmd(
        "import sys, shutil\n"
        f"shutil.copyfileobj(sys.stdin.buffer, open(r'{out_raw}', 'wb'))\n"
    )
    monkeypatch.setattr(writer, "_prepare_ffmpeg_cmd", lambda: sink)
    writer.write_frame(np.zeros((6, 8, 3), np.uint8))
    writer.close()
    assert (writer.height, writer.width) == (6, 8)
    assert len(out_raw.read_bytes()) == 6 * 8 * 3
    cmd = VideoWriter._prepare_ffmpeg_cmd(writer)
    assert cmd[cmd.index("-s") + 1] == "8x6"


def test_writer_surfaces_encode_errors(tmp_path, monkeypatch):
    writer = VideoWriter(tmp_path / "out.mp4", framerate=10)
    monkeypatch.setattr(writer, "_prepare_ffmpeg_cmd",
                        lambda: ["/nonexistent-binary-xyz"])
    with pytest.raises(FileNotFoundError):
        writer.write_frame(np.zeros((4, 4, 3), np.uint8))
        writer.close()


def test_writer_close_without_frames(tmp_path):
    writer = VideoWriter(tmp_path / "out.mp4", framerate=10)
    writer.close()
    with pytest.raises(VideoClosed):
        writer.write_frame(np.zeros((4, 4, 3), np.uint8))


def test_writer_slow_encoder_keeps_tail_frames(tmp_path, monkeypatch):
    """close() blocks until a live but slow encoder drains the queue."""
    old = get_config()
    set_config(dataclasses.replace(old, writer_buffer_frames=1))
    try:
        writer, out_raw = sink_writer(tmp_path, monkeypatch)

        def slow_render(value):
            time.sleep(1.2)  # slower than close()'s 0.5 s put timeout
            return np.full((4, 4, 3), value, np.uint8)

        for i in range(3):
            writer.write_frame(slow_render, i)
        writer.close()
        got = np.frombuffer(out_raw.read_bytes(), np.uint8)
        assert got.size == 3 * 4 * 4 * 3, "tail frames were dropped"
        for i, frame in enumerate(got.reshape(3, 4, 4, 3)):
            np.testing.assert_array_equal(frame, i)
    finally:
        set_config(old)


def test_writer_drain_timeout_warns_then_terminates(tmp_path, monkeypatch,
                                                    caplog):
    old = get_config()
    set_config(dataclasses.replace(old, writer_drain_timeout_s=0.3))
    try:
        writer = VideoWriter(tmp_path / "out.mp4", framerate=10)
        hang = python_cmd(
            "import sys, time\n"
            "sys.stdin.buffer.read()\n"
            "time.sleep(60)\n"
        )
        monkeypatch.setattr(writer, "_prepare_ffmpeg_cmd", lambda: hang)
        writer.write_frame(np.zeros((4, 4, 3), np.uint8))
        start = time.perf_counter()
        with caplog.at_level(logging.WARNING, logger="terran_tpu_torch"):
            writer.close()
        assert time.perf_counter() - start < 20
        assert any("terminating" in r.message for r in caplog.records)
    finally:
        set_config(old)


def test_writer_dead_thread_does_not_deadlock(tmp_path, monkeypatch):
    writer = VideoWriter(tmp_path / "out.mp4", framerate=10)
    monkeypatch.setattr(writer, "_prepare_ffmpeg_cmd",
                        lambda: ["/nonexistent-binary-xyz"])
    frame = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises((FileNotFoundError, RuntimeError)):
        for _ in range(200):
            writer.write_frame(frame)


def test_youtube_dl_stream_resolution(monkeypatch):
    """The optional youtube_dl resolution, with a stand-in module: a
    matching extractor resolves the URL, a non-matching one leaves the
    path, and extractor errors fall back to the raw path."""
    import types

    resolved = {}

    class FakeExtractor:
        def __init__(self, match):
            self._match = match

        def suitable(self, url):
            return self._match in url

    class FakeYDL:
        def __init__(self, options):
            resolved["options"] = options

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def extract_info(self, url, download=False):
            return {"url": f"https://cdn.example/{url.split('=')[-1]}.m3u8"}

    fake = types.ModuleType("youtube_dl")
    fake.gen_extractors = lambda: [FakeExtractor("youtube.com")]
    fake.YoutubeDL = FakeYDL
    fake.utils = types.SimpleNamespace(YoutubeDLError=RuntimeError)
    monkeypatch.setitem(sys.modules, "youtube_dl", fake)
    probed = {}

    def probe(path, **kwargs):
        probed["path"] = path
        return fake_probe(64, 48, "25/1")

    monkeypatch.setattr(reader, "ffmpeg_probe", probe)
    video = Video("https://youtube.com/watch?v=abc123", batch_size=2)
    assert video.is_stream
    assert video.stream_path == "https://cdn.example/abc123.m3u8"
    assert probed["path"] == video.stream_path
    assert resolved["options"]["format"] == "best"
    video.close()
    assert Video("https://example.org/live.m3u8").stream_path == \
        "https://example.org/live.m3u8"

    def boom(url, download=False):
        raise fake.utils.YoutubeDLError("nope")

    FakeYDL.extract_info = staticmethod(boom)
    assert Video("https://youtube.com/watch?v=zzz").stream_path == \
        "https://youtube.com/watch?v=zzz"


def test_webcam_device_path_is_stream(monkeypatch):
    probed = {}

    def probe(path, **kwargs):
        probed.update(path=path, kwargs=kwargs)
        return fake_probe(64, 48, "30/1")

    monkeypatch.setattr(reader, "ffmpeg_probe", probe)
    video = reader.open_video("/dev/video0", batch_size=2)
    assert video.is_stream and video.stream_path == "/dev/video0"
    assert probed["kwargs"]["probesize"] == 20 * 1024 * 1024
    assert probed["kwargs"]["analyzeduration"] == 10 * 1000 * 1000
    assert video.framerate == 30
    cmd = video._prepare_ffmpeg_cmd()
    assert "-probesize" in cmd and "-analyzeduration" in cmd
    assert cmd[cmd.index("-i") + 1] == "/dev/video0"
    assert cmd[cmd.index("-ss") + 1] == "00:00:05"
    video.close()


def test_synthetic_video():
    video = SyntheticVideo(width=32, height=16, num_frames=10, batch_size=4)
    batches = list(video)
    assert [b.shape for b in batches] == [
        (4, 16, 32, 3), (4, 16, 32, 3), (2, 16, 32, 3)]
    assert len(video) == 3
    with pytest.raises(EndOfVideo):
        video.read_frames()
    v2 = SyntheticVideo(width=32, height=16, num_frames=10, batch_size=4)
    np.testing.assert_array_equal(batches[0], v2.read_frames())
    with SyntheticVideo(num_frames=2) as v3:
        pass
    with pytest.raises(EndOfVideo):
        v3.read_frames()


# tests/test_parallel_video.py, on the port.

W, H, FPS = 8, 6, 10
PARALLEL_PROBE = fake_probe(W, H, f"{FPS}/1", 4.0)


def segment_emitter(seg_start, seg_duration):
    """Frames of [seg_start, seg_start + dur): frame k (global index) is a
    full frame of byte value k % 256."""
    first = int(round(seg_start * FPS))
    n = int(round(seg_duration * FPS))
    return python_cmd(
        "import sys\n"
        f"for k in range({first}, {first + n}):\n"
        f"    sys.stdout.buffer.write(bytes([k % 256]) * ({W * H * 3}))\n"
    )


def make_parallel_video(monkeypatch, cls=ParallelVideo, probe=PROBE,
                        **kwargs):
    monkeypatch.setattr(probe, lambda p, **kw: PARALLEL_PROBE)
    kwargs.setdefault("workers", 2)
    kwargs.setdefault("batch_size", 4)
    kwargs.setdefault("segment_time", 1.0)
    video = cls("/fake/video.mp4", **kwargs)
    monkeypatch.setattr(video, "_prepare_segment_cmd", segment_emitter)
    return video


def first_values(video):
    return [v for batch in video for v in batch[:, 0, 0, 0].tolist()]


def test_parallel_ordered_fan_in_two_workers(monkeypatch):
    video = make_parallel_video(monkeypatch)
    assert len(video.segments) == 4
    batches = list(video)
    assert all(b.shape[1:] == (H, W, 3) for b in batches)
    assert [v for b in batches for v in b[:, 0, 0, 0]] == list(range(40))
    assert len(batches) == 12  # 10 frames a segment at batch 4: 4 + 4 + 2


def test_parallel_single_worker_and_start_time(monkeypatch):
    video = make_parallel_video(monkeypatch, workers=1, batch_size=None)
    assert [frame[0, 0, 0] for frame in video] == list(range(40))
    video = make_parallel_video(monkeypatch, start_time=1.0, read_for=2.0,
                                batch_size=5)
    assert first_values(video) == list(range(10, 30))


def test_parallel_worker_exception_propagates_in_order(monkeypatch):
    video = make_parallel_video(monkeypatch)

    def flaky(seg_start, seg_duration):
        if int(round(seg_start * FPS)) == 20:
            raise RuntimeError("decoder exploded")
        return segment_emitter(seg_start, seg_duration)

    monkeypatch.setattr(video, "_prepare_segment_cmd", flaky)
    values = []
    with pytest.raises(RuntimeError, match="decoder exploded"):
        for batch in video:
            values.extend(batch[:, 0, 0, 0].tolist())
    assert values == list(range(20))
    with pytest.raises(RuntimeError, match="decoder exploded"):
        video.read_frames()
    video.close()
    for thread in video._threads:
        assert not thread.is_alive()
    with pytest.raises(VideoClosed):
        video.close()


def test_parallel_nonzero_exit_is_a_failure_not_eof(monkeypatch):
    video = make_parallel_video(monkeypatch, workers=1)

    def crashing(seg_start, seg_duration):
        if int(round(seg_start * FPS)) == 10:
            return python_cmd(
                "import sys\n"
                "for k in range(10, 15):\n"
                f"    sys.stdout.buffer.write(bytes([k]) * ({W * H * 3}))\n"
                "sys.stderr.write('simulated decoder crash')\n"
                "sys.exit(3)\n"
            )
        return segment_emitter(seg_start, seg_duration)

    monkeypatch.setattr(video, "_prepare_segment_cmd", crashing)
    values = []
    with pytest.raises(FFmpegError, match="code 3.*simulated decoder"):
        for batch in video:
            values.extend(batch[:, 0, 0, 0].tolist())
    assert values == list(range(15))


def test_parallel_close_mid_stream_joins_workers(monkeypatch):
    video = make_parallel_video(monkeypatch)
    assert video.read_frames()[0, 0, 0, 0] == 0
    video.close()
    for thread in video._threads:
        assert not thread.is_alive()
    with pytest.raises(EndOfVideo):
        video.read_frames()
    with pytest.raises(VideoClosed):
        video.close()


def test_parallel_rejects_streams_and_unknown_duration(monkeypatch):
    with pytest.raises(ValueError, match="seekable"):
        parallel.open_video_parallel("http://example.com/stream")
    monkeypatch.setattr(PROBE, lambda p, **kw: fake_probe(W, H, "10/1"))
    with pytest.raises(ValueError, match="duration"):
        ParallelVideo("/fake/video.mp4")


def test_parallel_len_and_framerate(monkeypatch):
    video = make_parallel_video(monkeypatch, batch_size=4)
    assert video.framerate == FPS
    assert len(video) == 10
    assert make_parallel_video(monkeypatch, framerate=5).framerate == 5


# tests/test_reader_stress.py, on the port.

def make_endless_video(monkeypatch, batch_size=2):
    monkeypatch.setattr(PROBE, lambda p, **kw: fake_probe(16, 12, "30/1",
                                                          1000.0))
    video = Video("/fake.mp4", batch_size=batch_size)
    emit = python_cmd(
        "import sys\n"
        "chunk = (bytes(range(256)) * 3)[:16 * 12 * 3]\n"
        "while True:\n"
        "    try:\n"
        "        sys.stdout.buffer.write(chunk)\n"
        "    except BrokenPipeError:\n"
        "        break\n"
    )
    monkeypatch.setattr(video, "_prepare_ffmpeg_cmd", lambda: emit)
    return video


def test_close_mid_stream_many_times(monkeypatch):
    for trial in range(8):
        video = make_endless_video(monkeypatch)
        for _ in range(trial % 3 + 1):
            assert video.read_frames().shape == (2, 12, 16, 3)
        video.close()
        assert not video._thread.is_alive()
        with pytest.raises(EndOfVideo):
            video.read_frames()


def test_close_without_reading(monkeypatch):
    video = make_endless_video(monkeypatch)
    video.close()
    assert video._closed


def test_close_while_consumer_blocked(monkeypatch):
    video = make_endless_video(monkeypatch)
    video.read_frames()
    results = []

    def consumer():
        try:
            for _ in range(1000):
                video.read_frames()
        except EndOfVideo:
            results.append("eof")
        except Exception as exc:  # pragma: no cover
            results.append(exc)

    thread = threading.Thread(target=consumer)
    thread.start()
    video.close()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert results in ([], ["eof"])


def test_no_thread_leak(monkeypatch):
    baseline = threading.active_count()
    for _ in range(5):
        video = make_endless_video(monkeypatch)
        video.read_frames()
        video.close()
    assert threading.active_count() <= baseline + 1


# The port's readers against the JAX package's, on the same emitters.

def test_video_frames_match_jax(monkeypatch):
    got = list(make_fake_video(monkeypatch, batch_size=3, num_frames=11))
    exp = list(make_fake_video(monkeypatch, batch_size=3, num_frames=11,
                               cls=JaxVideo, probe=JAX_PROBE))
    assert [g.shape for g in got] == [e.shape for e in exp]
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype == np.uint8
        np.testing.assert_array_equal(g, e)


def test_parallel_frames_match_jax(monkeypatch):
    got = list(make_parallel_video(monkeypatch, batch_size=3))
    exp = list(make_parallel_video(monkeypatch, batch_size=3,
                                   cls=JaxParallelVideo, probe=JAX_PROBE))
    assert [g.shape for g in got] == [e.shape for e in exp]
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("pattern", ["gradient", "noise"])
@pytest.mark.parametrize("batch_size", [None, 3])
def test_synthetic_video_matches_jax(pattern, batch_size):
    kwargs = dict(width=40, height=24, num_frames=20, batch_size=batch_size,
                  seed=7, pattern=pattern, framerate=25)
    got, exp = SyntheticVideo(**kwargs), JaxSyntheticVideo(**kwargs)
    assert (len(got), got.framerate, got.duration) == (
        len(exp), exp.framerate, exp.duration)
    pairs = list(zip(got, exp))
    assert len(pairs) == len(exp)
    for g, e in pairs:
        assert g.dtype == e.dtype and g.shape == e.shape
        np.testing.assert_array_equal(g, e)
    with pytest.raises(EndOfVideo):  # this package's class, not JAX's
        got.read_frames()
