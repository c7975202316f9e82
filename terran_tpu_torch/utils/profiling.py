"""Logging, tracing and host-side timing for the package.

- ``get_logger``: the package's logger.
- ``trace(name)``: a context manager that marks a region for
  ``torch.profiler`` (``record_function``) and records its wall time into
  the ``global_timer()``.
- ``profiler_range(name)``: a range in the running profiler's trace only
  while a profiler records the calling thread, else a shared no-op
  context; the pipeline's stages, the int8 convs and the stream trackers
  open ``terran::<name>`` ranges through it.
- ``start_trace(log_dir)``/``stop_trace()``: capture one
  ``torch.profiler`` trace (host, plus the card's kernels when a card is
  visible) into a ``*.pt.trace.json`` under ``log_dir``, which
  TensorBoard's PyTorch profiler plugin and ``chrome://tracing`` open.
- ``StageTimer``: per-stage wall time and item counts, which the
  pipeline's ``timer=`` hook records into.
- ``Timeline``: per-batch spans against one origin, which the pipeline's
  ``timeline`` attribute records into.

``StageTimer`` and ``Timeline`` are copies of
``terran_tpu/utils/profiling.py``'s; ``StageTimer`` also takes a lock,
since the pipeline's worker threads record into it. Both read the host
clock: on the card a dispatch span is the time to enqueue the work, not
the device time, as under JAX's asynchronous dispatch.
"""

import contextlib
import logging
import threading
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity


def get_logger(name="terran_tpu_torch"):
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"
        ))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


NO_RANGE = contextlib.nullcontext()


def profiling():
    """Whether a ``torch.profiler`` records the calling thread's ops now.
    The test is thread-local: a thread that the profiler does not record
    (one started before it, such as the pipeline's upload thread) reads
    False. It costs a fraction of a microsecond; entering even a range
    that no profiler records costs more."""
    return torch._C._autograd._profiler_enabled()


def profiler_range(name, *fields):
    """A range named ``name.format(*fields)`` in the trace while a profiler
    records the calling thread, else the shared ``NO_RANGE``; the name is
    formatted only when the range opens. The range is a host op
    (``RecordFunctionFast``), not a ``record_function`` user annotation,
    which the profiler also mirrors onto the device's timeline as one
    event spanning the kernels launched inside it, idle time between them
    included."""
    if not profiling():
        return NO_RANGE
    return torch._C._profiler._RecordFunctionFast(
        name.format(*fields) if fields else name)


@contextlib.contextmanager
def trace(name):
    """Annotate a region for torch.profiler and record its wall time into
    the global timer; a block that raises records nothing. The region is
    a ``record_function`` user annotation, entered only while a profiler
    records the calling thread."""
    start = time.perf_counter()
    with (torch.profiler.record_function(name) if profiling()
          else NO_RANGE):
        yield
    _GLOBAL_TIMER.record(name, time.perf_counter() - start)


_profiler = None


def start_trace(log_dir):
    """Start capturing a trace that ``stop_trace()`` writes under
    ``log_dir``; only one runs at a time."""
    global _profiler
    if _profiler is not None:
        raise RuntimeError("Profile has already been started. Only one "
                           "profile may be run at a time.")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(str(log_dir)),
    )
    profiler.start()
    _profiler = profiler


def stop_trace():
    """Stop the trace that ``start_trace`` started and write it."""
    global _profiler

    if _profiler is None:
        raise RuntimeError("No profile started")
    profiler, _profiler = _profiler, None
    profiler.stop()


class StageTimer:
    """Accumulates per-stage wall time and item counts."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.items = defaultdict(int)
        self._lock = threading.Lock()

    def record(self, name, seconds, items=0):
        with self._lock:
            self.times[name] += seconds
            self.counts[name] += 1
            self.items[name] += items

    @contextlib.contextmanager
    def stage(self, name, items=0):
        start = time.perf_counter()
        yield
        self.record(name, time.perf_counter() - start, items)

    def summary(self):
        """Per-stage dict of total seconds, calls, mean latency, items/sec."""
        out = {}
        with self._lock:
            times = dict(self.times)
        for name, total in times.items():
            calls = self.counts[name]
            items = self.items[name]
            out[name] = {
                "total_s": round(total, 4),
                "calls": calls,
                "mean_ms": round(1000 * total / max(calls, 1), 3),
                "items_per_s": (
                    round(items / total, 2) if total > 0 and items else None
                ),
            }
        return out

    def reset(self):
        with self._lock:
            self.times.clear()
            self.counts.clear()
            self.items.clear()


class Timeline:
    """Per-batch event timeline for pipeline serialization analysis.

    Records (batch id, event, start, end, bytes) spans against one shared
    origin so overlap (or its absence) between uploads, dispatches, and
    fetches across batches is directly visible. Wall spans measure where
    the HOST waited.
    """

    def __init__(self):
        self.events = []
        self.origin = time.perf_counter()

    @contextlib.contextmanager
    def span(self, batch, event, nbytes=0):
        start = time.perf_counter()
        yield
        self.events.append(
            (batch, event, start - self.origin,
             time.perf_counter() - self.origin, int(nbytes))
        )

    def mark(self, batch, event, nbytes=0):
        t = time.perf_counter() - self.origin
        self.events.append((batch, event, t, t, int(nbytes)))

    def rows(self):
        """Compact [batch, event, start_ms, dur_ms, bytes] rows."""
        return [
            [b, e, round(s * 1000, 1), round((t - s) * 1000, 1), n]
            for b, e, s, t, n in sorted(self.events, key=lambda r: r[2])
        ]


_GLOBAL_TIMER = StageTimer()


def global_timer():
    return _GLOBAL_TIMER
