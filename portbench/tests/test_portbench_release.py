"""The readers of the pipeline's release records (``metrics/
early_release_pct*.py``) on hand-built StageTimer counts, and on runs
that made no release record or attached no timer, which find nothing to
read."""

from types import SimpleNamespace

import pytest

from run import BENCH, load_file

READERS = ("early_release_pct", "early_release_pct.cameras")


def reader(name):
    return load_file(BENCH / "metrics" / f"{name}.py", f"test_{name}")


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("counts,expected", [
    ({"release_early": 99, "release_depth": 1, "release_wait": 100}, 99.0),
    ({"release_early": 40}, 100.0),
    ({"release_depth": 40, "release_wait": 40}, 0.0),
    ({"release_wait": 10, "graph_replay": 30}, None),
])
def test_early_share_from_the_records(name, counts, expected):
    ctx = SimpleNamespace(timer=SimpleNamespace(counts=counts))
    assert reader(name).read(ctx) == expected


@pytest.mark.parametrize("name", READERS)
def test_no_timer_reads_nothing(name):
    assert reader(name).read(SimpleNamespace(timer=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_stage_timer_is_read(name):
    from terran_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    for release in ("release_early",) * 3 + ("release_depth",):
        timer.record("release_wait", 0.001)
        timer.record(release, 0.0, 1)
    assert reader(name).read(SimpleNamespace(timer=timer)) == 75.0
