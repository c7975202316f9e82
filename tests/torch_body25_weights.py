"""BODY_25 weights for the port's tests, drawn from the benchmark's plain
reference's table (``portbench/reference/body25.py::body25_specs``: the
prototxt's keys, shapes and initialisation), so that the tests and the
benchmark share one description of the network.

The reference is loaded from its folder and unloaded again
(:func:`loaded_reference`): its package name, ``reference``, is the
benchmark's and is not kept in ``sys.modules``.
"""

import contextlib
import importlib
import sys
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1] / "portbench"

# Narrow widths for the CPU: the trunk's 12 convs (published 64, 64, 128,
# 128, 256, 256, 256, 256, 512, 512, 256, 128) and each stage's (dense
# width, Mconv6 width) (published (96, 256), then (128, 512) but for the
# first heatmap stage's (96, 256)).
NARROW_TRUNK = (8, 8, 16, 16, 16, 16, 16, 16, 32, 32, 16, 16)
NARROW_STAGES = ((8, 16), (12, 24), (12, 24), (12, 24), (8, 16), (12, 24))


def _loaded():
    return {name: module for name, module in sys.modules.items()
            if name == "reference" or name.startswith("reference.")}


@contextlib.contextmanager
def loaded_reference():
    """The module ``reference.body25`` of the benchmark's folder, with any
    other ``reference`` package set aside while it is loaded and put back
    after."""
    before = _loaded()
    for name in before:
        del sys.modules[name]
    sys.path.insert(0, str(BENCH))
    try:
        yield importlib.import_module("reference.body25")
    finally:
        sys.path.remove(str(BENCH))
        for name in _loaded():
            del sys.modules[name]
        sys.modules.update(before)


def body25_state_dict(rng, trunk=NARROW_TRUNK, stages=NARROW_STAGES):
    """{key: float32 array} of BODY_25 at the given widths (narrow by
    default), each tensor drawn from ``rng`` as ``body25_specs`` says."""
    with loaded_reference() as reference:
        specs = reference.body25_specs(trunk, stages)
    sd = {}
    for key, shape, init in specs:
        draw = rng.standard_normal(shape)
        if init[0] == "normal":
            value = draw * init[1]
        elif init[0] == "abs_plus":
            value = np.abs(draw * init[1]) + init[2]
        else:
            raise ValueError(f"unknown init {init} for {key}")
        sd[key] = value.astype(np.float32)
    return sd
