"""Readings of the program's own profiler ranges: the ``terran::<stage>``
ranges of ``PerceptionPipeline``, ``terran::quant_conv ...`` of each int8
conv and ``terran::track`` of ``MultiStreamPerception``, and its
``StageTimer`` records ``track`` and ``release_wait``.

They read what the existing tracer keeps of each profile: the host
events by name and time (``Tracer.host``), the kernels and copies by
time, and the marked windows. The program opens a range only on a
thread the profiler records, which is the thread that started it: the
one that iterates the stream and dispatches. So every ``terran::`` range
here is on the dispatching thread.

A kernel's launch is found by order. The profiled kernels run on the
pipeline's one compute stream in the order they were launched, and
every profile ends in a synchronise, so the last k kernel-launch calls
of a profile launched its last k kernels; kernels before those were
launched before the profile began, and launches before those lost their
kernel's record (the profiler loses a few as it starts). The pairing
reads no timestamp: the profiler's device clock runs off the host's by
up to milliseconds in some profiles, so a kernel can appear to start
before its launch. A record lost inside a profile would shift the pairs
before it by one.

Each reading returns None where the run has nothing to read (a program
without these ranges or records), and the harness then leaves the
metric out of the result line."""

import re
from bisect import bisect_right

from harness import bounds
from harness.stats import gaps_of, merged

PREFIX = "terran::"
ENQUEUE = ("perception_step", "pose_dispatch", "embed_dispatch",
           "limb_dispatch")
CONV = re.compile(r"terran::quant_conv n(\d+) h(\d+) w(\d+) c(\d+) o(\d+) "
                  r"k(\d+) s(\d+) p(\d+)$")
# CUDA API calls (cuda* and the lower-level cu*) that launch one kernel each.
LAUNCH = re.compile(r"cu(da)?Launch(Cooperative)?Kernel")
NO_STAGE = "(no stage)"


def kind(name):
    """'terran::quant_conv n8 ...' -> 'quant_conv'."""
    return name[len(PREFIX):].split(" ", 1)[0]


def ranges(tracer):
    """(name, start_ns, end_ns) of every ``terran::`` host range."""
    return [r for r in tracer.host if r[0].startswith(PREFIX)]


def outermost(intervals):
    """The ranges of ``intervals`` that no other contains, sorted by start:
    on one thread ranges nest, so these tile the stages."""
    out = []
    for r in sorted(intervals, key=lambda r: (r[1], -r[2])):
        if not out or r[1] >= out[-1][2]:
            out.append(r)
    return out


def overlap(a, b):
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _clip(intervals, ws, we):
    return [(max(s, ws), min(t, we)) for s, t in intervals
            if t > ws and s < we]


def idle_in_enqueue_pct(tracer):
    """Share of the marked windows in which no kernel or copy runs on any
    stream while the dispatching thread is inside an enqueue stage."""
    enqueue = [(s, t) for n, s, t in ranges(tracer) if kind(n) in ENQUEUE]
    window = sum(we - ws for ws, we, _ in tracer.windows)
    if not enqueue or not window:
        return None
    busy = [(s, t) for _, s, t in tracer.kernels + tracer.copies]
    idle = 0
    for ws, we, _ in tracer.windows:
        gaps = gaps_of(_clip(busy, ws, we), ws, we)
        idle += overlap(gaps, merged(_clip(enqueue, ws, we)))
    return 100.0 * idle / window


def _segments(tracer):
    """Each window's profile as (first_ns, last_ns): profiles lie seconds
    apart, so the midpoints between windows part them."""
    windows = sorted((ws, we) for ws, we, _ in tracer.windows)
    cuts = [(we + ws2) / 2 for (_, we), (ws2, _) in zip(windows, windows[1:])]
    edges = [float("-inf")] + cuts + [float("inf")]
    return list(zip(edges, edges[1:]))


def launches(tracer):
    """(launch_ns, kernel or None) for every kernel-launch call of the
    profiles, in order: the kernel as (name, start_ns, end_ns), None where
    its record was lost."""
    calls = sorted(s for n, s, _ in tracer.host if LAUNCH.match(n))
    kernels = sorted(tracer.kernels, key=lambda k: k[1])
    out = []
    for lo, hi in _segments(tracer):
        mine = [s for s in calls if lo <= s < hi]
        ran = [k for k in kernels if lo <= k[1] < hi]
        lost = max(0, len(mine) - len(ran))
        out += [(s, None) for s in mine[:lost]]
        out += list(zip(mine[lost:], ran[len(ran) - len(mine) + lost:]))
    return out


def conv_bound_s(name, itemsize):
    """Least time of the conv a ``terran::quant_conv`` range names: its
    2 n ho wo k^2 c o operations at the int8 peak, or its input and output
    in the compute dtype and its int8 weights once over HBM, whichever is
    larger."""
    n, h, w, c, o, k, s, p = map(int, CONV.match(name).groups())
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    ops = 2.0 * n * ho * wo * k * k * c * o
    nbytes = (n * h * w * c + n * ho * wo * o) * itemsize + o * c * k * k
    return max(ops / bounds.PEAK_INT8_OPS, nbytes / bounds.PEAK_BYTES)


def quant_conv_roofline(tracer, itemsize):
    """Least time of the profiled int8 convs over the device time of the
    kernels launched inside their ranges; convs with a lost kernel record
    are left out of both."""
    convs = sorted((r for r in ranges(tracer) if CONV.match(r[0])),
                   key=lambda r: r[1])
    if not convs:
        return None
    starts = [s for _, s, _ in convs]
    device = [0] * len(convs)
    lost = set()
    for at, kernel in launches(tracer):
        i = bisect_right(starts, at) - 1
        if i < 0 or at > convs[i][2]:
            continue
        if kernel is None:
            lost.add(i)
        else:
            device[i] += kernel[2] - kernel[1]
    kept = [i for i in range(len(convs)) if i not in lost]
    device_ns = sum(device[i] for i in kept)
    if not device_ns:
        return None
    least = sum(conv_bound_s(convs[i][0], itemsize) for i in kept)
    return 100.0 * least / (device_ns / 1e9)


def stage_table(tracer):
    """{stage: {host_ms, device_ms, launches}} a batch inside the marked
    windows: host time in the stage's outermost ranges, and the kernels
    whose launch call fell inside one, with their device time. Launches
    outside every stage count under '(no stage)', and those whose kernel
    record was lost under 'unpaired_launches'. None without ranges."""
    stages = outermost(ranges(tracer))
    batches = sum(b for _, _, b in tracer.windows)
    if not stages or not batches:
        return None
    table, unpaired = {}, 0

    def row(name):
        return table.setdefault(name, {"host_ms": 0.0, "device_ms": 0.0,
                                       "launches": 0})

    for ws, we, _ in tracer.windows:
        for name, s, t in stages:
            if t > ws and s < we:
                row(kind(name))["host_ms"] += (min(t, we) - max(s, ws)) / 1e6
    starts = [s for _, s, _ in stages]
    for at, kernel in launches(tracer):
        if not any(ws <= at < we for ws, we, _ in tracer.windows):
            continue
        i = bisect_right(starts, at) - 1
        inside = i >= 0 and at <= stages[i][2]
        entry = row(kind(stages[i][0]) if inside else NO_STAGE)
        entry["launches"] += 1
        if kernel is None:
            unpaired += 1
        else:
            entry["device_ms"] += (kernel[2] - kernel[1]) / 1e6
    out = {name: {key: value / batches for key, value in entry.items()}
           for name, entry in sorted(table.items())}
    out["unpaired_launches"] = unpaired / batches
    return out


def note_stage_table(ctx):
    """Put :func:`stage_table` into the result line's ``extra`` once, as
    ``stage_ranges``: the harness prints no other breakdown of a new
    kind."""
    if "stage_ranges" not in ctx.extra:
        table = stage_table(ctx.tracer)
        if table is not None:
            ctx.extra["stage_ranges"] = table


def timer_ms(ctx, stage):
    """Host ms a record of the program's ``StageTimer`` stage ``stage``,
    over the whole window; None where the program made none."""
    timer = ctx.timer
    calls = timer.counts.get(stage, 0) if timer is not None else 0
    if not calls:
        return None
    return 1e3 * timer.times[stage] / calls
