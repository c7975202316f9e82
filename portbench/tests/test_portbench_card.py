"""On the card (skipped elsewhere): every cell runs briefly through the
benchmark's command and comes out correct, and the control at the
cells' own size does not. Run there with ``python -m pytest
portbench/tests -m card``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["bf16-offline-1080p", "int8-offline-1080p", "bf16-cameras-1080p"]


def _run(workload, seed, *extra):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "3", "--trace", "0", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_card(card, workload):
    out = _run(workload, 2 ** 31 + 11)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS[:2])
def test_control_is_not_correct_on_the_card(card, workload):
    out = _run(workload, 2 ** 31 + 12, "--control", "1")
    assert not out["correct"], out["checks"]
