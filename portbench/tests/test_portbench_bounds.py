"""The benchmark's copies of the kernel bounds and its operation count
against the repository's own."""

import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, load
from harness import bounds, flops


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("m, h, w, k", [
    (8 * 18, 23, 40, 16),     # the pipeline's batch at pose side 184
    (8 * 18, 23, 40, 32),     # the pose task's K
    (1 * 18, 23, 40, 128),
])
def test_peak_bound_equals_chip_smoke(smoke, m, h, w, k):
    assert bounds.kernel_bound_ms(m, h, w, k) == smoke.kernel_bound_ms(
        m, h, w, k)


@pytest.mark.parametrize("k", [64, 256, 1024])
def test_nms_bound_equals_chip_smoke(smoke, k):
    from terran_tpu_torch.ops.nms import nms_fixed

    rng = np.random.default_rng(k)
    boxes, scores = smoke.random_boxes(rng, 8, 2 * k, 416, 739)
    boxes, scores = torch.from_numpy(boxes), torch.from_numpy(scores)
    top, top_scores, keep, _, _ = nms_fixed(boxes, scores, 0.4,
                                            score_threshold=0.5, top_k=k)
    valid = torch.isfinite(top_scores)
    assert torch.equal(bounds.nms_tests(top, valid, keep, 0.4),
                       smoke.nms_tests(top, valid, keep, 0.4))
    assert bounds.nms_bound_ms(top, valid, keep, 0.4) == smoke.nms_bound_ms(
        top, valid, keep, 0.4)


def test_int_mm_bound_takes_the_larger_of_operations_and_bytes():
    big = bounds.int_mm_bound_s(4096, 4096, 4096)
    assert big == pytest.approx(2 * 4096 ** 3 / 1979e12)
    thin = bounds.int_mm_bound_s(200704, 576, 8)
    assert thin == pytest.approx((200704 * 576 + 576 * 8 + 4 * 200704 * 8)
                                 / 3.35e12)


def _counted(model, x):
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops()


@pytest.mark.parametrize("h, w", [(64, 96), (80, 112)])
def test_flops_match_the_flop_counter_on_the_programs_models(h, w):
    from terran_tpu_torch.models.arcface import FaceResNet100
    from terran_tpu_torch.models.openpose import BodyPoseModel
    from terran_tpu_torch.models.retinaface import RetinaFace

    with torch.no_grad():
        assert flops.model_flops("retinaface", h, w) == _counted(
            RetinaFace().eval(), torch.zeros(1, h, w, 3))
        assert flops.model_flops("openpose", h, w) == _counted(
            BodyPoseModel().eval(), torch.zeros(1, h, w, 3))
        assert flops.model_flops("arcface", 112, 112) == _counted(
            FaceResNet100().eval(), torch.zeros(1, 112, 112, 3))


# Operations of one input of each family at the committed cells' sizes
# (1080 x 1920 frames at detection side 416 and pose side 184), as the
# harness counted them before families were found by name.
PARENT_FLOPS = {"retinaface": ((416, 739), 1489649408),
                "openpose": ((184, 327), 118614914048),
                "arcface": ((112, 112), 24179212288)}


@pytest.mark.parametrize("family", sorted(PARENT_FLOPS))
def test_model_flops_equal_the_counts_recorded_before_families(family):
    size, count = PARENT_FLOPS[family]
    assert flops.model_flops(family, *size) == count


@pytest.mark.parametrize("workload", ["bf16-offline-1080p",
                                      "int8-offline-1080p",
                                      "bf16-cameras-1080p"])
def test_frame_flops_at_the_cells_sizes(workload):
    from harness.cell import Cell

    cell = Cell(workload, load(ROOT / "BENCHMARK.json"))
    h, w = cell.mix["frame"]
    per = flops.frame_flops(cell.families, h, w, cell.pipe_cfg)
    # 416 x 739 for detection, 184 x 327 for pose, 112 x 112 a face.
    assert per == {f: c for f, (_, c) in PARENT_FLOPS.items()}
    assert per["arcface"] == pytest.approx(24.18e9, rel=1e-3)


def test_the_count_takes_every_leading_dimension_and_products():
    ops = flops._Counting()
    x = torch.empty((5, 144, 768), device="meta")
    y = ops.linear(x, torch.empty((96, 768), device="meta"),
                   torch.empty((96,), device="meta"))
    assert ops.flops == 2 * 5 * 144 * 768 * 96
    q = y.reshape(5, 144, 8, 12).transpose(1, 2)  # (5, 8, 144, 12)
    ops.flops = 0
    scores = ops.matmul(q, q.transpose(-1, -2))
    assert tuple(scores.shape) == (5, 8, 144, 144)
    assert ops.flops == 2 * (5 * 8) * 144 * 12 * 144
