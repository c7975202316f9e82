"""The port's native (C++) pose assembly vs its Python version and the JAX
package's assembly, on test_native.py's random decode outputs.

Peak ids and keypoint counts compare exactly; score sums within 1e-9
(the C++ merge adds a human's two sums and the limb score in another
association than the Python version).
"""

import numpy as np
import pytest

from terran_tpu.pose import assembly as jax_assembly
from terran_tpu_torch import native
from terran_tpu_torch.ops.pose_decode import COCO_18
from terran_tpu_torch.pose import assembly
from test_native import random_decode_outputs


def assert_same_humans(got, expected):
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got[:, :18], expected[:, :18])
    np.testing.assert_array_equal(got[:, 19], expected[:, 19])
    np.testing.assert_allclose(got[:, 18], expected[:, 18], rtol=0,
                               atol=1e-9)


def test_the_library_builds_here():
    assert native.native_available(), native.build_error()
    assert native.build_seconds() is not None


@pytest.mark.parametrize("seed", range(4))
def test_greedy_connections_match_python(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        k = int(rng.integers(1, 12))
        reg = rng.uniform(-0.5, 1.0, size=(k, k)).astype(np.float32)
        accept = rng.uniform(size=(k, k)) < 0.4
        count_src, count_dst = rng.integers(1, k + 1, size=2)
        expected = assembly.greedy_connections(reg, accept, count_src,
                                               count_dst)
        got = native.greedy_connections_native(reg, accept, count_src,
                                               count_dst)
        np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("k,peak_prob,accept_prob", [
    (8, 0.5, 0.2),
    (10, 0.9, 0.7),   # dense: merges, overlap tiebreaks, 3+ matches
    (16, 0.9, 0.3),   # the pipeline's K
    (32, 0.9, 0.3),
    (4, 0.2, 0.9),
])
def test_native_assembly_matches_python_and_jax(k, peak_prob, accept_prob):
    rng = np.random.default_rng(k)
    humans_seen = 0
    for trial in range(8):
        outputs = random_decode_outputs(rng, k, peak_prob, accept_prob)
        peaks_n, humans_n = assembly.assemble_humans(*outputs,
                                                     use_native=True)
        peaks_p, humans_p = assembly.assemble_humans(*outputs,
                                                     use_native=False)
        _, humans_j = jax_assembly.assemble_humans(*outputs,
                                                   use_native=False)
        _, humans_jn = jax_assembly.assemble_humans(*outputs,
                                                    use_native=True)
        np.testing.assert_array_equal(peaks_n, peaks_p)
        assert_same_humans(humans_n, humans_p)
        np.testing.assert_array_equal(humans_p, humans_j)
        assert_same_humans(humans_n, humans_jn)
        humans_seen += len(humans_p)
        kp_n = assembly.get_keypoints(peaks_n, humans_n, scale=0.5)
        kp_j = jax_assembly.get_keypoints(peaks_p, humans_j, scale=0.5)
        for a, b in zip(kp_n, kp_j):
            np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
    if accept_prob >= 0.3:
        assert humans_seen > 0


@pytest.mark.parametrize("use_native", [True, False])
def test_no_peaks_no_humans(use_native):
    parts, limbs = COCO_18.parts, COCO_18.limbs
    outputs = (np.zeros((parts, 4, 2), np.int32),
               np.zeros((parts, 4), np.float32),
               np.zeros((parts, 4), bool),
               np.zeros((limbs, 4, 4), np.float32),
               np.zeros((limbs, 4, 4), bool))
    peaks, humans = assembly.assemble_humans(*outputs, use_native=use_native)
    assert peaks.shape == (0, 3)
    assert humans.shape == (0, 20)


def test_native_off_by_environment(monkeypatch):
    """TERRAN_TPU_NATIVE=0 leaves the Python version, with equal humans."""
    outputs = random_decode_outputs(np.random.default_rng(9), 10, 0.9, 0.7)
    _, with_native = assembly.assemble_humans(*outputs)
    monkeypatch.setenv("TERRAN_TPU_NATIVE", "0")
    assert not native.native_available()
    _, without = assembly.assemble_humans(*outputs)
    assert_same_humans(with_native, without)


def test_inconsistent_shapes_raise():
    coords, scores, valid, reg, accept = random_decode_outputs(
        np.random.default_rng(3))
    counts = valid.sum(axis=1)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    with pytest.raises(ValueError, match="inconsistent"):
        native.assemble_humans_native(scores[:, :4], counts, offsets, reg,
                                      accept, COCO_18.limbseq,
                                      COCO_18.starts)
    with pytest.raises(ValueError, match="inconsistent"):
        native.assemble_humans_native(scores, counts, offsets, reg,
                                      accept,
                                      COCO_18.limbseq + COCO_18.parts,
                                      COCO_18.starts)
