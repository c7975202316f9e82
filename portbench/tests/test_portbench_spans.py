"""The readings of the program's own ranges (``harness/spans.py``) on
hand-built host ranges, launch calls and kernel intervals, against values
worked out by hand; and the same readers on a run without the ranges,
which find nothing to read."""

from types import SimpleNamespace

import pytest

from harness import bounds, spans

CONV = "terran::quant_conv n1 h4 w4 c8 o8 k3 s1 p1"


def tracer(host=(), kernels=(), copies=(), windows=((0, 100, 1),)):
    return SimpleNamespace(host=list(host), kernels=list(kernels),
                           copies=list(copies), windows=list(windows))


def launch(at):
    return ("cudaLaunchKernel", at, at + 1)


def test_idle_in_enqueue_counts_idle_time_inside_enqueue_stages():
    t = tracer(
        host=[("terran::perception_step", 0, 30),
              ("terran::embed_dispatch", 40, 80),
              (CONV, 45, 50),                     # nested: counted once
              ("terran::det_fetch", 80, 95),      # not an enqueue stage
              ("aten::add", 0, 100),
              ("terran::limb_dispatch", 1000, 1050)],
        kernels=[("k", 10, 20), ("k", 50, 60)],
        copies=[("Memcpy_HtoD_", 55, 70)],
        windows=[(0, 100, 1), (1000, 1100, 1)])
    # Idle [0, 10], [20, 50], [70, 100] meets enqueue [0, 30], [40, 80]
    # in 10 + 10 + 10 + 10; the second window is idle throughout, 50 of
    # it in limb_dispatch.
    assert spans.idle_in_enqueue_pct(t) == pytest.approx(
        100.0 * (40 + 50) / 200)


def test_idle_in_enqueue_is_the_idle_share_when_enqueueing_throughout():
    t = tracer(host=[("terran::pose_dispatch", 0, 100)],
               kernels=[("k", 10, 20), ("k", 30, 90)])
    assert spans.idle_in_enqueue_pct(t) == pytest.approx(30.0)
    t.host = [("terran::pose_dispatch", 0, 25)]
    assert spans.idle_in_enqueue_pct(t) == pytest.approx(15.0)


def test_launches_pair_from_the_profiles_end():
    # A kernel launched before the profile began runs first and is left
    # over; the second profile lost the record of its first kernel.
    t = tracer(
        host=[launch(110), launch(150), launch(250),
              launch(5000), launch(5010)],
        kernels=[("early", 5, 8), ("a", 300, 310), ("b", 320, 340),
                 ("c", 350, 400), ("e", 5100, 5200)],
        windows=[(100, 500, 1), (5000, 5500, 1)])
    assert spans.launches(t) == [
        (110, ("a", 300, 310)), (150, ("b", 320, 340)),
        (250, ("c", 350, 400)), (5000, None), (5010, ("e", 5100, 5200))]


def test_pairing_reads_no_timestamp():
    # The device clock may run off the host's: kernels that appear to
    # start before their launches still pair by order.
    t = tracer(host=[launch(100), launch(110), launch(150)],
               kernels=[("a", 90, 95), ("b", 96, 99), ("c", 140, 145)])
    assert spans.launches(t) == [(100, ("a", 90, 95)), (110, ("b", 96, 99)),
                                 (150, ("c", 140, 145))]


def test_quant_conv_roofline_by_hand():
    t = tracer(
        host=[(CONV, 100, 200), launch(110), launch(150), launch(250)],
        kernels=[("early", 5, 8), ("im2col", 300, 310),
                 ("cutlass::Kernel2", 320, 340), ("other", 350, 400)],
        windows=[(0, 1000, 1)])
    # n1 h4 w4 c8 o8 k3 s1 p1: 2 * 16 * 9 * 8 * 8 operations; 16 * 8
    # input and 16 * 8 output values of 2 bytes, 8 * 8 * 9 int8 weights.
    ops, nbytes = 2 * 16 * 9 * 64, (128 + 128) * 2 + 576
    least = max(ops / bounds.PEAK_INT8_OPS, nbytes / bounds.PEAK_BYTES)
    assert spans.conv_bound_s(CONV, 2) == least
    assert spans.quant_conv_roofline(t, 2) == pytest.approx(
        100.0 * least / 30e-9)


@pytest.mark.parametrize("name,k,s,p,ops", [
    ("terran::quant_conv n2 h7 w6 c3 o16 k3 s2 p1", 3, 2, 1,
     2 * 2 * 4 * 3 * 9 * 3 * 16),
    ("terran::quant_conv n8 h46 w82 c128 o128 k3 s1 p1", 3, 1, 1,
     2 * 8 * 46 * 82 * 9 * 128 * 128),
    ("terran::quant_conv n4 h8 w8 c16 o8 k1 s2 p0", 1, 2, 0,
     2 * 4 * 4 * 4 * 16 * 8),
])
def test_conv_bound_counts_the_convs_operations(name, k, s, p, ops,
                                                monkeypatch):
    # At an unbounded bandwidth the bound is the operations' time alone.
    monkeypatch.setattr(bounds, "PEAK_BYTES", float("inf"))
    assert spans.conv_bound_s(name, 2) == ops / bounds.PEAK_INT8_OPS


def test_quant_conv_roofline_leaves_out_convs_with_lost_records():
    t = tracer(host=[(CONV, 100, 200), launch(110), launch(150)],
               kernels=[("a", 300, 310)], windows=[(0, 1000, 1)])
    assert spans.quant_conv_roofline(t, 2) is None


def test_stage_table_by_hand():
    t = tracer(
        host=[("terran::perception_step", 0, 100),
              ("terran::embed_dispatch", 200, 400),
              (CONV, 250, 300),
              launch(10), launch(50), launch(260), launch(350),
              launch(500), launch(2000)],
        kernels=[("a", 600, 610), ("b", 620, 630), ("c", 640, 660),
                 ("d", 700, 740), ("e", 800, 900), ("f", 2100, 2200)],
        windows=[(0, 1000, 2), (1900, 1950, 0)])
    table = spans.stage_table(t)
    ms = 1e-6 / 2   # ns to ms, over 2 batches
    assert table == {
        "perception_step": {"host_ms": pytest.approx(100 * ms),
                            "device_ms": pytest.approx(20 * ms),
                            "launches": 1.0},
        "embed_dispatch": {"host_ms": pytest.approx(200 * ms),
                           "device_ms": pytest.approx(60 * ms),
                           "launches": 1.0},
        spans.NO_STAGE: {"host_ms": 0.0,
                         "device_ms": pytest.approx(100 * ms),
                         "launches": 0.5},
        "unpaired_launches": 0.0}
    # The launch at 2000 lies outside both windows.
    launched = sum(v["launches"] for k, v in table.items()
                   if k != "unpaired_launches")
    assert launched * 2 == 5


def test_readers_find_nothing_without_the_programs_ranges():
    """A run of a program without the ranges and records (one from before
    they were added) reads None, which leaves the metrics out of the
    line."""
    t = tracer(host=[("aten::conv2d", 0, 50), launch(10)],
               kernels=[("k", 20, 30)])
    assert spans.idle_in_enqueue_pct(t) is None
    assert spans.quant_conv_roofline(t, 2) is None
    assert spans.stage_table(t) is None
    ctx = SimpleNamespace(tracer=t, timer=None, extra={})
    spans.note_stage_table(ctx)
    assert ctx.extra == {}
    assert spans.timer_ms(ctx, "track") is None


def test_timer_ms_is_the_mean_record():
    from terran_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    for seconds in (0.010, 0.030):
        timer.record("release_wait", seconds)
    ctx = SimpleNamespace(timer=timer)
    assert spans.timer_ms(ctx, "release_wait") == pytest.approx(20.0)
    assert spans.timer_ms(ctx, "track") is None
