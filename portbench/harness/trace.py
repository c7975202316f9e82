"""Short ``torch.profiler`` windows spread over a traced run, kept in
memory, and what the per-layer metrics read from them.

A window opens at the first batch boundary after its planned time, lets
one batch pass with the profiler on (its start-up), then marks the next
``WINDOW_BATCHES`` batches with a ``record_function`` range; the device's
activity is read inside that range only. Whole-window traces would run
past a GiB, so three windows of a few batches stand for the run.

The profiler stalls the host-bound loop while it runs. So the host-side
readings (frames, faces, spans) are taken outside the profiled spans:
the tracer snapshots its watched running totals where a span starts and
at the first batch boundary after it stops, and the readings leave those
differences, and that time, out."""

import re

import torch

from harness.stats import union_length, gaps_of

WINDOWS = (0.2, 0.5, 0.8)
WINDOW_BATCHES = 3
MARK = "portbench_window"


def short_name(name):
    """A kernel's name without its return type, namespace of the
    translation unit, template and argument lists:
    'void (anonymous namespace)::scan_kernel(float const*, ...)' ->
    'scan_kernel'; cut to 96 characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0][:96] or name[:96]


def _ns(event, which):
    getter = getattr(event, f"{which}_ns", None)
    if getter is not None:
        return getter()
    return getattr(event, f"{which}_us")() * 1000


class Tracer:
    """``step()`` at every batch boundary of the window; a no-op unless
    ``enabled``."""

    def __init__(self, enabled, seconds, start_time):
        self.enabled = enabled
        self.plan = [start_time + f * seconds for f in WINDOWS]
        self.prof = None
        self.phase = 0
        self.mark = None
        self.windows = []  # (start_ns, end_ns, batches)
        self.kernels = []  # (name, start_ns, end_ns)
        self.copies = []
        self.host = []     # (name, start_ns, end_ns) of CPU ops
        self.int_mm = []   # (count, device_us, (m, k, n))
        self.done = []
        self.gauges = {}   # name: running total, read at batch boundaries
        self.t0 = start_time
        self.last = None   # (time, totals) at the last batch boundary
        self.span = None   # (time, totals) where the open span started
        self.first_span = None  # time the first span started
        self.closing = False
        self.excluded = {}
        self.excluded_s = 0.0

    def watch(self, **gauges):
        """Running totals (callables) to read outside the profiled spans."""
        self.gauges.update(gauges)

    def _totals(self):
        return {name: gauge() for name, gauge in self.gauges.items()}

    def _end_span(self, now, totals):
        start, before = self.span
        self.excluded_s += now - start
        for name, value in totals.items():
            self.excluded[name] = (self.excluded.get(name, 0)
                                   + value - before.get(name, 0))
        self.span, self.closing = None, False

    def outside(self, name):
        """A watched total at the window's last batch boundary, less what
        it gained inside the profiled spans; None if never read."""
        if self.last is None or name not in self.last[1]:
            return None
        return self.last[1][name] - self.excluded.get(name, 0)

    def outside_s(self):
        """Seconds from the window's start to its last batch boundary,
        less the profiled spans."""
        if self.last is None:
            return None
        return self.last[0] - self.t0 - self.excluded_s

    def warm(self):
        """Start and stop one profile, so that the first window does not
        pay the tracing library's start-up."""
        if not self.enabled:
            return
        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @staticmethod
    def _activities():
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def step(self, now):
        if not self.enabled:
            return
        totals = self._totals()
        self.last = (now, totals)
        if self.closing:
            self._end_span(now, totals)
        if self.prof is None:
            if self.plan and now >= self.plan[0]:
                self.plan.pop(0)
                self.span = (now, totals)
                if self.first_span is None:
                    self.first_span = now
                self.prof = torch.profiler.profile(
                    activities=self._activities(), record_shapes=True)
                self.prof.start()
                self.phase = 0
            return
        self.phase += 1
        if self.phase == 1:
            self.mark = torch.profiler.record_function(MARK)
            self.mark.__enter__()
        elif self.phase == 1 + WINDOW_BATCHES:
            self.mark.__exit__(None, None, None)
            torch.cuda.synchronize()
            self.prof.stop()
            self.done.append(self.prof)
            self.prof = None
            self.closing = True

    def close(self):
        """Stop a window the run ended inside (it is not read), then read
        the finished ones: after the window, so that reading costs the
        measured run nothing."""
        if self.prof is not None:
            if self.mark is not None and self.phase >= 1:
                self.mark.__exit__(None, None, None)
            self.prof.stop()
            self.prof = None
        if self.span is not None:
            self._end_span(*self.last)
        for prof in self.done:
            self._collect(prof)
        self.done = []

    def _collect(self, prof):
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        marks = [e for e in events if e.name() == MARK
                 and e.device_type() == DeviceType.CPU]
        if not marks:
            return
        start = _ns(marks[0], "start")
        end = start + _ns(marks[0], "duration")
        self.windows.append((start, end, WINDOW_BATCHES))
        for e in events:
            s = _ns(e, "start")
            t = s + _ns(e, "duration")
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith("ProfilerStep") or name == MARK:
                    continue
                target = (self.copies if name.startswith(("Memcpy", "Memset"))
                          else self.kernels)
                target.append((name, s, t))
            elif name != MARK and not name.startswith("ProfilerStep"):
                self.host.append((name, s, t))
        for row in prof.key_averages(group_by_input_shape=True):
            if row.key == "aten::_int_mm" and row.input_shapes:
                (m, k), (_, n) = row.input_shapes[0], row.input_shapes[1]
                self.int_mm.append((row.count, row.device_time_total,
                                    (m, k, n)))

    # ---- readings -------------------------------------------------------

    def _in_windows(self, intervals):
        for name, s, t in intervals:
            for ws, we, _ in self.windows:
                if t > ws and s < we:
                    yield name, max(s, ws), min(t, we)

    def window_s(self):
        return sum(we - ws for ws, we, _ in self.windows) / 1e9

    def busy_s(self):
        busy = list(self._in_windows(self.kernels + self.copies))
        total = 0.0
        for ws, we, _ in self.windows:
            total += union_length([(s, t) for _, s, t in busy
                                   if s >= ws and t <= we])
        return total / 1e9

    def launches_per_batch(self):
        batches = sum(b for _, _, b in self.windows)
        if not batches:
            return None
        starts = sum(1 for _, s, _ in self.kernels
                     for ws, we, _ in self.windows if ws <= s < we)
        return starts / batches

    def kernel_ms(self, name):
        """Mean device ms of one record of kernel ``name`` over every
        profiled span, or None when none was seen."""
        times = [t - s for n, s, t in self.kernels if short_name(n) == name]
        return sum(times) / len(times) / 1e6 if times else None

    def breakdown(self):
        by_name = {}
        for name, s, t in self._in_windows(self.kernels + self.copies):
            key = short_name(name)
            by_name[key] = by_name.get(key, 0.0) + (t - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = []
        for ws, we, _ in self.windows:
            busy = [(s, t) for _, s, t in self._in_windows(
                self.kernels + self.copies) if s >= ws and t <= we]
            gaps += gaps_of(busy, ws, we)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self._host_during(gs, ge), (ge - gs) / 1e9]
                              for gs, ge in gaps]}

    def _host_during(self, gs, ge):
        best, best_overlap = "host outside any op", 0
        for name, s, t in self.host:
            overlap = min(t, ge) - max(s, gs)
            if overlap > best_overlap:
                best, best_overlap = name, overlap
        return best
