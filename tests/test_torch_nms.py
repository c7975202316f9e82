"""Port's fixed-K NMS vs the JAX package's, on the CPU (the suppression's
plain version): ``keep``, ``order`` and ``overflow`` equal exactly; kept
boxes and scores equal exactly (both are gathers of the inputs); the IoU
matrix equal to 1 ulp-scale (2e-7 absolute on values in [0, 1]). The
plain suppression also matches ``nms_numpy_reference``."""

import numpy as np
import pytest
import torch

from terran_tpu.ops import nms as jax_nms
from terran_tpu_torch.ops import nms
from torch_port_fixtures import single_torch_thread  # noqa: F401


def random_boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size, size=(n, 2))
    wh = rng.uniform(5, 60, size=(n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def nonfinite_boxes(rng, n):
    """Boxes as exp overflow in the decode gives them: inf widths, and
    inf - inf = NaN corners."""
    boxes = random_boxes(rng, n)
    boxes[::5, 2] = np.inf
    boxes[1::5, 0] = -np.inf
    boxes[1::5, 2] = np.inf
    boxes[2::5, 1] = np.nan
    boxes[3::5] = np.array([-np.inf, -np.inf, np.inf, np.inf], np.float32)
    return boxes


def case(name, rng):
    """(boxes, scores, score_threshold, top_k) of a named case."""
    if name == "random":
        return (random_boxes(rng, 100),
                rng.uniform(0, 1, 100).astype(np.float32), 0.3, 128)
    if name == "ties":
        # Equal scores on clustered boxes: the order is the index order.
        boxes = random_boxes(rng, 60, size=40.0)
        scores = np.repeat(np.float32([0.9, 0.8, 0.7]), 20)
        return boxes, scores, 0.5, 64
    if name == "identical":
        boxes = np.tile(np.float32([[10, 10, 50, 50]]), (40, 1))
        return boxes, np.full(40, 0.75, np.float32), 0.5, 32
    if name == "empty":
        return (random_boxes(rng, 10), np.zeros(10, np.float32), 0.5, 16)
    if name == "top_k_above_a":
        return (random_boxes(rng, 20),
                rng.uniform(0, 1, 20).astype(np.float32), 0.2, 64)
    if name == "overflow":
        return (random_boxes(rng, 200),
                rng.uniform(0.5, 1.0, 200).astype(np.float32), 0.3, 32)
    if name == "nonfinite":
        return (nonfinite_boxes(rng, 80),
                rng.uniform(0, 1, 80).astype(np.float32), 0.1, 64)
    raise ValueError(name)


CASES = ["random", "ties", "identical", "empty", "top_k_above_a",
         "overflow", "nonfinite"]


@pytest.mark.parametrize("name", CASES)
def test_nms_fixed_matches_jax(name):
    rng = np.random.default_rng(CASES.index(name))
    boxes, scores, score_threshold, top_k = case(name, rng)
    got = nms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                        0.4, score_threshold=score_threshold, top_k=top_k)
    exp = jax_nms.nms_fixed(boxes, scores, 0.4,
                            score_threshold=score_threshold, top_k=top_k)
    g_boxes, g_scores, g_keep, g_order, g_overflow = (t.numpy() for t in got)
    e_boxes, e_scores, e_keep, e_order, e_overflow = (np.asarray(t)
                                                      for t in exp)
    assert g_keep.shape == (top_k,) and g_keep.dtype == np.bool_
    np.testing.assert_array_equal(g_keep, e_keep)
    np.testing.assert_array_equal(g_order, e_order)
    np.testing.assert_array_equal(g_overflow, e_overflow)
    np.testing.assert_array_equal(g_scores, e_scores)
    np.testing.assert_array_equal(g_boxes, e_boxes)


def test_cases_exercise_their_branch():
    rng = np.random.default_rng(0)
    for name, check in (
        ("empty", lambda keep, order, overflow: not keep.any()),
        ("overflow", lambda keep, order, overflow: bool(overflow)),
        ("top_k_above_a", lambda keep, order, overflow: keep[20:].sum() == 0),
        ("identical", lambda keep, order, overflow: keep.sum() == 1
         and order[0] == 0),
        ("nonfinite", lambda keep, order, overflow: keep.sum() > 0),
    ):
        boxes, scores, thr, top_k = case(name, rng)
        _, _, keep, order, overflow = nms.nms_fixed(
            torch.from_numpy(boxes), torch.from_numpy(scores), 0.4,
            score_threshold=thr, top_k=top_k)
        assert check(keep.numpy(), order.numpy(), overflow.numpy()), name


def test_batched_equals_per_image():
    rng = np.random.default_rng(5)
    boxes = np.stack([random_boxes(rng, 90) for _ in range(3)])
    scores = rng.uniform(0, 1, (3, 90)).astype(np.float32)
    batched = nms.nms_fixed(torch.from_numpy(boxes), torch.from_numpy(scores),
                            0.4, score_threshold=0.2, top_k=64)
    for i in range(3):
        single = nms.nms_fixed(torch.from_numpy(boxes[i]),
                               torch.from_numpy(scores[i]), 0.4,
                               score_threshold=0.2, top_k=64)
        for b, s in zip(batched, single):
            assert torch.equal(b[i], s)


@pytest.mark.parametrize("nonfinite", [False, True])
def test_iou_matrix_matches_jax(nonfinite):
    rng = np.random.default_rng(2)
    boxes = nonfinite_boxes(rng, 40) if nonfinite else random_boxes(rng, 40)
    got = nms.iou_matrix(torch.from_numpy(boxes),
                         torch.from_numpy(boxes)).numpy()
    exp = np.asarray(jax_nms.iou_matrix(boxes, boxes))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, exp, rtol=0, atol=2e-7)


@pytest.mark.parametrize("seed", range(4))
def test_plain_suppression_matches_numpy_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    boxes = random_boxes(rng, 120)
    scores = rng.uniform(0, 1, 120).astype(np.float32)
    _, _, keep, order, _ = nms.nms_fixed(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.4,
        score_threshold=0.3, top_k=128)
    got = set(order.numpy()[keep.numpy()].tolist())
    valid = scores >= 0.3
    expected_rel = nms.nms_numpy_reference(boxes[valid], scores[valid], 0.4)
    assert got == set(np.flatnonzero(valid)[expected_rel].tolist())


def test_numpy_reference_is_the_jax_one():
    rng = np.random.default_rng(9)
    boxes = random_boxes(rng, 50)
    scores = rng.uniform(0, 1, 50).astype(np.float32)
    np.testing.assert_array_equal(
        nms.nms_numpy_reference(boxes, scores, 0.4),
        jax_nms.nms_numpy_reference(boxes, scores, 0.4))


def test_suppress_rejects_what_it_cannot_run():
    boxes = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="valid"):
        nms.suppress(boxes, torch.ones((1, 5), dtype=torch.bool), 0.4)
    with pytest.raises(ValueError, match="no NMS kernel"):
        nms.suppress(boxes.to("meta"),
                     torch.ones((1, 4), dtype=torch.bool, device="meta"), 0.4)
    launches = nms.suppress.launches
    nms.suppress(boxes, torch.ones((1, 4), dtype=torch.bool), 0.4)
    assert nms.suppress.launches == launches  # the plain version
