"""Port's tracing names (``trace``, ``global_timer``, ``start_trace``,
``stop_trace``) against the JAX package's, on the CPU."""

import gzip
import json
import sys

import pytest
import torch

from terran_tpu.utils import profiling as jax_profiling
from terran_tpu_torch.utils import profiling

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
