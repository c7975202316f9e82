"""The readers of the pipeline's graph records (``metrics/graph_replay_pct
*.py``) on hand-built StageTimer counts, and on runs that made no record
or attached no timer, which find nothing to read."""

from types import SimpleNamespace

import pytest

from run import BENCH, load_file

READERS = ("graph_replay_pct", "graph_replay_pct.cameras")


def reader(name):
    return load_file(BENCH / "metrics" / f"{name}.py", f"test_{name}")


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("counts,expected", [
    ({"graph_replay": 38, "graph_eager": 2}, 95.0),
    ({"graph_replay": 40}, 100.0),
    ({"graph_eager": 40, "perception_step": 10}, 0.0),
    ({"perception_step": 10}, None),
])
def test_replay_share_from_the_records(name, counts, expected):
    ctx = SimpleNamespace(timer=SimpleNamespace(counts=counts))
    assert reader(name).read(ctx) == expected


@pytest.mark.parametrize("name", READERS)
def test_no_timer_reads_nothing(name):
    assert reader(name).read(SimpleNamespace(timer=None)) is None
