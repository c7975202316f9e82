"""Port's tracing names (``trace``, ``global_timer``, ``start_trace``,
``stop_trace``) against the JAX package's, on the CPU; then the port's
own profiler ranges (``terran::<stage>``, ``terran::quant_conv ...``,
``terran::track``), which open only while a profiler records, and the
``release_wait`` and ``track`` records of a ``StageTimer``."""

import contextlib
import gzip
import json
import re
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from terran_tpu.utils import profiling as jax_profiling
from terran_tpu_torch.io.streams import MultiStreamPerception
from terran_tpu_torch.models import quant
from terran_tpu_torch.models.openpose import _Int8ConvBias
from terran_tpu_torch import pipeline as pipeline_module
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.utils import profiling
from terran_tpu_torch.utils.convert import (
    convert_openpose, convert_retinaface,
)
from torch_oracle import (
    random_openpose_state_dict, random_retinaface_state_dict,
)
from torch_port_fixtures import single_torch_thread_module  # noqa: F401

PACKAGES = {"jax": jax_profiling, "torch": profiling}

# The stand-in modules that tests/reference_shims.py installs; importing
# tests/test_reference_crosscheck.py installs them, so every process that
# collects the whole suite has them.
STAND_INS = ("torchvision", "sklearn", "skimage", "ffmpeg", "filterpy")


@pytest.fixture(autouse=True)
def hide_stand_ins(monkeypatch):
    """The first profile a process starts imports torch._inductor, whose
    import asks importlib.util.find_spec about optional packages, and
    find_spec raises on a module without a spec. The stand-ins have none,
    so they are hidden while a test here runs."""
    for name, module in list(sys.modules.items()):
        if (name.split(".")[0] in STAND_INS
                and getattr(module, "__spec__", None) is None):
            monkeypatch.delitem(sys.modules, name)


@pytest.fixture(params=sorted(PACKAGES))
def package(request):
    return PACKAGES[request.param]


@pytest.fixture
def stops_trace():
    """Stops, after the test, any trace the test left running."""
    started = []
    yield started
    for package in started:
        try:
            package.stop_trace()
        except RuntimeError:
            pass


def test_trace_records_once_per_block(package):
    timer = package.global_timer()
    before = timer.counts.get("unit-test-trace", 0)
    with package.trace("unit-test-trace"):
        pass
    with package.trace("unit-test-trace"):
        pass
    assert timer.counts["unit-test-trace"] == before + 2
    assert timer.times["unit-test-trace"] >= 0


def test_trace_records_nothing_after_an_exception(package):
    timer = package.global_timer()
    with pytest.raises(ValueError):
        with package.trace("unit-test-trace-raises"):
            raise ValueError("inside the block")
    assert timer.counts.get("unit-test-trace-raises", 0) == 0


def test_global_timer_is_one_stage_timer(package):
    assert package.global_timer() is package.global_timer()
    assert isinstance(package.global_timer(), package.StageTimer)


def test_stop_without_start_raises(package):
    with pytest.raises(RuntimeError, match="No profile started"):
        package.stop_trace()


def test_second_start_raises(package, tmp_path, stops_trace):
    package.start_trace(tmp_path / "first")
    stops_trace.append(package)
    with pytest.raises(RuntimeError, match="already been started"):
        package.start_trace(tmp_path / "second")


def trace_events(package, log_dir):
    """The written trace's events: the port's ``*.pt.trace.json``, JAX's
    ``*.trace.json.gz``."""
    if package is profiling:
        (path,) = log_dir.glob("*.pt.trace.json")
        return json.loads(path.read_text())["traceEvents"]
    (path,) = log_dir.glob("plugins/profile/*/*.trace.json.gz")
    return json.loads(gzip.decompress(path.read_bytes()))["traceEvents"]


def test_trace_written_holds_the_region(package, tmp_path, stops_trace):
    timer = package.global_timer()
    before = timer.counts.get("unit-test-traced-region", 0)
    package.start_trace(tmp_path)
    stops_trace.append(package)
    with package.trace("unit-test-traced-region"):
        torch.ones(64).sum()
    stops_trace.pop()
    package.stop_trace()
    names = {event.get("name") for event in trace_events(package, tmp_path)}
    assert "unit-test-traced-region" in names
    assert timer.counts["unit-test-traced-region"] == before + 1
    # Stopped: a new trace may start.
    package.start_trace(tmp_path / "again")
    stops_trace.append(package)


def test_trace_on_the_cpu_records_host_activity_only(tmp_path, stops_trace):
    profiling.start_trace(tmp_path)
    stops_trace.append(profiling)
    torch.ones(8).add_(1)
    stops_trace.pop()
    profiling.stop_trace()
    events = trace_events(profiling, tmp_path)
    assert not [e for e in events if e.get("cat") == "kernel"]
    assert any(e.get("name") == "aten::add_" for e in events)


@pytest.mark.parametrize("card,expected", [
    (False, ["CPU"]), (True, ["CPU", "CUDA"]),
])
def test_trace_activities_follow_the_card(card, expected, tmp_path,
                                          monkeypatch, stops_trace):
    """The card's kernels are traced whenever a card is visible."""
    made = []

    class Recorder:
        def __init__(self, activities, on_trace_ready):
            made.append([a.name for a in activities])

        def start(self):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.profiler, "profile", Recorder)
    profiling.start_trace(tmp_path)
    stops_trace.append(profiling)
    assert made == [expected]


# ---------------------------------------------------------------------------
# The package's own ranges and records
# ---------------------------------------------------------------------------

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
# The stages a device-plan batch with pose and no embeddings runs on the
# thread that iterates process_stream (h2d_thread runs on the upload
# thread, which the profiler does not record).
MAIN_THREAD_STAGES = ("perception_step", "pose_dispatch", "det_fetch",
                      "pose_fetch", "limb_dispatch", "limb_fetch",
                      "pose_assembly")


# What opens a profiler range: the user annotation and the host op range.
RANGE_OPENERS = ((torch.profiler, "record_function"),
                 (torch._C._profiler, "_RecordFunctionFast"))


@pytest.fixture(scope="module")
def tiny_params():
    rng = np.random.default_rng(33)
    return (convert_retinaface(random_retinaface_state_dict(rng)),
            convert_openpose(random_openpose_state_dict(rng)))


def tiny_pipeline(params, timer=None, **kwargs):
    """Detection and pose at det short side 64 and pose 32 on the CPU, no
    embeddings."""
    det, pose = params
    return PerceptionPipeline(
        det, None, pose, device="cpu", with_embeddings=False, top_k=16,
        max_faces=4, max_peaks=8, max_escalations=0, det_short_side=64,
        pose_short_side=32, timer=timer, **kwargs)


def tiny_batches(count, batch=2):
    rng = np.random.default_rng(7)
    return [rng.integers(0, 255, (batch, 128, 192, 3), dtype=np.uint8)
            for _ in range(count)]


class FakePipeline:
    """``process_stream`` and ``faces_from`` of a pipeline that finds one
    face a frame; ``timer`` as the real one's."""

    def __init__(self, timer=None):
        self.timer = timer

    def process_stream(self, batches):
        for frames in batches:
            yield {"n": len(frames)}

    @staticmethod
    def faces_from(out):
        return [[{"bbox": np.array([0, 0, 10, 10], np.int32),
                  "landmarks": np.zeros((5, 2), np.int32),
                  "score": np.float32(0.9)}] for _ in range(out["n"])]


class FrameSource:
    """A source of ``count`` 8x8 frames, one a read."""

    framerate = 30

    def __init__(self, count):
        self.left = count

    def read_frames(self):
        if not self.left:
            raise StopIteration
        self.left -= 1
        return np.zeros((8, 8, 3), np.uint8)


def run_streams(pipeline, frames=6, sources=2, batch=4):
    """Every batch of ``MultiStreamPerception`` with tracking over
    ``sources`` sources of ``frames`` frames each."""
    return list(MultiStreamPerception(
        pipeline, [FrameSource(frames) for _ in range(sources)],
        batch_size=batch, track=True))


def small_conv(kernel=3, stride=1, padding=1, n=1, h=6, w=5, c=8, o=4):
    """A random NHWC input and int8 OIHW weight with per-channel scales."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((n, h, w, c), generator=gen)
    weight = torch.randn((o, c, kernel, kernel), generator=gen)
    weight_q, scale = quant.quantize_conv_weight(weight)
    return x, weight_q, scale


def int8_conv_bias():
    """The int8 OpenPose conv, which dequantises on its own."""
    layer = _Int8ConvBias(8, 4, 3, 1, "relu", torch.float32)
    x, weight_q, scale = small_conv()
    layer.weight_q.copy_(weight_q)
    layer.weight_scale.copy_(scale)
    return lambda: layer(x)


def quant_conv_call():
    x, weight_q, scale = small_conv()
    return lambda: quant.quant_conv(x, weight_q, scale, 1, 1, torch.float32)


WORK = {
    "stage": lambda params: (lambda: list(tiny_pipeline(params)
                                          .process_stream(tiny_batches(2)))),
    "quant_conv": lambda params: quant_conv_call(),
    "int8_conv_bias": lambda params: int8_conv_bias(),
    "streams": lambda params: (lambda: run_streams(FakePipeline())),
}


@pytest.mark.parametrize("work", sorted(WORK))
def test_ranges_open_only_while_a_profiler_records(work, tiny_params,
                                                   monkeypatch):
    """With no profiler running the package opens no range of either kind
    and the pipeline builds no ExitStack; under a profiler the same work
    opens ``terran::`` ranges."""
    entered, stacks = [], []

    def counting(opener):
        def open_range(name, *args, **kwargs):
            entered.append(name)
            return opener(name, *args, **kwargs)
        return open_range

    class CountingStack(contextlib.ExitStack):
        def __init__(self):
            stacks.append(self)
            super().__init__()

    for module, name in RANGE_OPENERS:
        monkeypatch.setattr(module, name,
                            counting(getattr(module, name)))
    # The pipeline's own module only: torch builds ExitStacks of its own.
    monkeypatch.setattr(pipeline_module, "contextlib",
                        SimpleNamespace(ExitStack=CountingStack))
    run = WORK[work](tiny_params)
    run()
    assert entered == [] and stacks == []
    with torch.profiler.profile(activities=CPU_ONLY):
        run()
    assert entered and all(name.startswith("terran::") for name in entered)


def test_trace_annotates_only_while_a_profiler_records(monkeypatch):
    """``trace`` stays a record_function user annotation, entered only
    under a profiler; its timing is kept either way."""
    entered = []
    record_function = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer = profiling.global_timer()
    before = timer.counts.get("unit-test-gated", 0)
    with profiling.trace("unit-test-gated"):
        pass
    assert entered == []
    with torch.profiler.profile(activities=CPU_ONLY):
        with profiling.trace("unit-test-gated"):
            pass
    assert entered == ["unit-test-gated"]
    assert timer.counts["unit-test-gated"] == before + 2


def test_stage_is_the_shared_no_op_when_off(tiny_params):
    pipe = tiny_pipeline(tiny_params)
    assert pipe._stage("perception_step", items=2, batch=0) is (
        profiling.NO_RANGE)
    with torch.profiler.profile(activities=CPU_ONLY):
        assert pipe._stage("perception_step") is not profiling.NO_RANGE


@pytest.mark.parametrize("timer", [False, True])
def test_stage_ranges_in_the_profile(tiny_params, timer):
    """A small process_stream under the profiler shows the pipeline's
    stages as ``terran::<stage>`` rows, with or without a StageTimer."""
    pipe = tiny_pipeline(tiny_params,
                         profiling.StageTimer() if timer else None)
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        outs = list(pipe.process_stream(tiny_batches(3), depth=2))
    assert len(outs) == 3
    rows = {row.key: row.count for row in prof.key_averages()}
    for stage in MAIN_THREAD_STAGES:
        assert rows.get(f"terran::{stage}") == 3, stage


def conv_ops_of(name):
    """2 n ho wo k^2 c o of a ``terran::quant_conv`` range's name."""
    dims = dict((key, int(value)) for key, value in
                re.findall(r" ([a-z])(\d+)", name))
    ho = (dims["h"] + 2 * dims["p"] - dims["k"]) // dims["s"] + 1
    wo = (dims["w"] + 2 * dims["p"] - dims["k"]) // dims["s"] + 1
    return (2 * dims["n"] * ho * wo * dims["k"] ** 2 * dims["c"]
            * dims["o"])


@pytest.mark.parametrize("kernel,stride,padding,n,h,w,c,o", [
    (3, 1, 1, 1, 6, 5, 8, 4), (3, 2, 1, 2, 7, 6, 3, 16),
    (1, 2, 0, 2, 8, 8, 16, 8), (7, 1, 3, 1, 9, 9, 4, 4),
])
def test_quant_conv_range_gives_the_conv_work(kernel, stride, padding, n, h,
                                              w, c, o):
    """The range's dims give the plain conv's 2 M K N: M output pixels, K
    = k^2 c, N = o."""
    x, weight_q, scale = small_conv(kernel, stride, padding, n, h, w, c, o)
    with torch.profiler.profile(activities=CPU_ONLY) as prof:
        y = quant.quant_conv(x, weight_q, scale, stride, padding,
                             torch.float32)
    (name,) = [row.key for row in prof.key_averages()
               if row.key.startswith("terran::quant_conv")]
    assert name == quant.CONV_RANGE.format(n, h, w, c, o, kernel, stride,
                                           padding)
    plain = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), weight_q.float(), stride=stride,
        padding=padding)
    m = plain.shape[0] * plain.shape[2] * plain.shape[3]
    assert y.shape == (plain.shape[0], plain.shape[2], plain.shape[3], o)
    assert conv_ops_of(name) == 2 * m * (kernel * kernel * c) * o


class RecordingTimer(profiling.StageTimer):
    """A StageTimer that also keeps every value it records."""

    def __init__(self):
        super().__init__()
        self.values = {}

    def record(self, name, seconds, items=0):
        self.values.setdefault(name, []).append((seconds, items))
        super().record(name, seconds, items)


@pytest.mark.parametrize("count", [1, 4])
def test_release_wait_once_a_batch(tiny_params, count):
    timer = RecordingTimer()
    pipe = tiny_pipeline(tiny_params, timer)
    start = time.perf_counter()
    outs = list(pipe.process_stream(tiny_batches(count), depth=2))
    wall = time.perf_counter() - start
    assert len(outs) == count
    waits = timer.values["release_wait"]
    assert len(waits) == count
    assert all(0 <= seconds <= wall for seconds, _ in waits)


PLANS = {"device": {}, "host": {"transfer_plan": "host",
                                 "host_resize": "exact"}}
FEED_TIMEOUT_S = 60


def gated_feed(batches, received):
    """``batches``, batch i+1 only once result i was received (a live
    source whose next frames are not filmed yet); a result that never
    comes fails the feed, and with it the stream, instead of hanging."""
    for i, batch in enumerate(batches):
        if i and not received[i - 1].wait(timeout=FEED_TIMEOUT_S):
            raise TimeoutError(f"result {i - 1} was not released")
        yield batch


def run_feed(params, feed, count, plan="device", monkeypatch=None):
    """The results and recorded timer of ``count`` tiny batches streamed
    through a tiny pipeline at depth 2, from a ``feed`` of: 'gated'
    (``gated_feed``), 'ready' (each dispatch returns only once the
    uploads hold the next batch or the end) or 'unfetched' (no prefetch,
    the batches handed over directly)."""
    from terran_tpu_torch.io.video import prefetch

    timer = RecordingTimer()
    pipe = tiny_pipeline(params, timer, **PLANS[plan])
    batches = tiny_batches(count)
    received = [threading.Event() for _ in batches]
    if feed == "ready":
        feeds, put = [], prefetch.threaded_device_put

        def kept(*args, **kwargs):
            feeds.append(put(*args, **kwargs))
            return feeds[-1]

        monkeypatch.setattr(prefetch, "threaded_device_put", kept)
        dispatch = pipe.dispatch_batch

        def dispatch_then_wait(*args, **kwargs):
            out = dispatch(*args, **kwargs)
            deadline = time.monotonic() + FEED_TIMEOUT_S
            while not feeds[-1].ready():
                assert time.monotonic() < deadline, "the feed never filled"
                time.sleep(0.001)
            return out

        pipe.dispatch_batch = dispatch_then_wait
    source = gated_feed(batches, received) if feed == "gated" else batches
    outs = []
    for out in pipe.process_stream(source, depth=2,
                                   prefetch=feed != "unfetched"):
        received[len(outs)].set()
        outs.append(out)
    pipe.close()
    return outs, timer


def assert_same_tree(got, expected):
    """Equal dicts, lists and arrays, leaf for leaf."""
    if isinstance(expected, dict):
        assert got.keys() == expected.keys()
        for key in expected:
            assert_same_tree(got[key], expected[key])
    elif isinstance(expected, (list, tuple)):
        assert len(got) == len(expected)
        for a, b in zip(got, expected):
            assert_same_tree(a, b)
    else:
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_a_gated_feed_is_released_early(tiny_params, plan):
    """A feed that makes batch i+1 only after result i arrived: under the
    depth schedule alone result 0 would wait for batch 3 and the feed
    would time out. Each result is released while the feed has nothing
    ready, and equals the unfetched stream's."""
    count = 4
    outs, timer = run_feed(tiny_params, "gated", count, plan)
    assert len(outs) == count
    expected, _ = run_feed(tiny_params, "unfetched", count, plan)
    assert_same_tree(outs, expected)
    # The last may find the end already queued and leave as the tail.
    assert len(timer.values["release_early"]) >= count - 1


def test_a_ready_feed_keeps_the_depth_schedule(tiny_params, monkeypatch):
    count = 5
    outs, timer = run_feed(tiny_params, "ready", count,
                           monkeypatch=monkeypatch)
    expected, _ = run_feed(tiny_params, "unfetched", count)
    assert_same_tree(outs, expected)
    assert "release_early" not in timer.values
    assert len(timer.values["release_depth"]) == count


@pytest.mark.parametrize("feed", ["gated", "ready", "unfetched"])
def test_one_release_record_a_batch(tiny_params, monkeypatch, feed):
    count = 3
    outs, timer = run_feed(tiny_params, feed, count,
                           monkeypatch=monkeypatch)
    assert len(outs) == count
    records = (timer.values.get("release_early", [])
               + timer.values.get("release_depth", []))
    assert records == [(0.0, 1)] * count
    assert len(timer.values["release_wait"]) == count
    if feed == "unfetched":
        assert "release_early" not in timer.values


@pytest.mark.parametrize("frames,sources,batch", [(6, 2, 4), (3, 3, 2)])
def test_track_once_a_batch(frames, sources, batch):
    timer = RecordingTimer()
    batches = run_streams(FakePipeline(timer), frames, sources, batch)
    tracks = timer.values["track"]
    assert len(tracks) == len(batches)
    assert [items for _, items in tracks] == [len(b) for b in batches]
    assert all(seconds >= 0 for seconds, _ in tracks)
    assert sum(len(b) for b in batches) == frames * sources
