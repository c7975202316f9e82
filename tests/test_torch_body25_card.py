"""BODY_25 on the card; skipped without one.

- The fused x8 upsample and peak scan (``csrc/fused_peaks.cu``) at
  BODY_25's 25 parts on its 46 x 81 field (a 1080p frame at the pose short
  side 368: 12 x 11 tiles a plane), read in place from the 78-channel
  output as the pipeline hands it over, equal to the plain version bit for
  bit (coords, scores, valid and overflow), at the pipeline's K = 16, at
  K = 128 and at a K = 512 that holds every peak (the field's planes hold
  a few hundred each, so K = 16 and 128 overflow them).
- ``PerceptionPipeline(pose='body25')`` at published widths: the replay of
  its captured CUDA graphs equal to its eager programs bit for bit
  (peak tables, limbs and humans), every pose call replayed.

This file imports no JAX, which the card's machine lacks, and needs no
conftest: run it there with ``python -m pytest
tests/test_torch_body25_card.py -m card --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from terran_tpu_torch import pipeline as pipeline_module
from terran_tpu_torch.models import body25
from terran_tpu_torch.ops.fused_peaks import (
    find_peaks_fused, find_peaks_fused_plain, num_tiles,
)
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.utils.convert import convert_body25, convert_retinaface
from torch_body25_weights import body25_state_dict
from torch_oracle import random_retinaface_state_dict

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def smooth_output(gen, dev):
    """(8, 46, 81, 78) float32: 26 smooth heatmaps and 52 PAF channels, a
    random field's x3 box blur, so that the peaks are a few hundred a
    plane and some are near ties."""
    x = torch.randn((8, 78, 46, 81), generator=gen, device=dev)
    x = torch.nn.functional.avg_pool2d(x, 3, stride=1, padding=1)
    return x.permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("k", [16, 128, 512])
def test_the_peak_kernel_at_25_parts(card, k):
    gen = torch.Generator(device=card).manual_seed(25)
    out = smooth_output(gen, card)
    heat = out[..., :25]  # in place: stride 78 between pixels
    assert num_tiles(46, 81) == 132
    got = find_peaks_fused(heat, 0.1, k)
    want = find_peaks_fused_plain(heat, 0.1, k)
    for a, b, name in zip(got, want, ("coords", "scores", "valid",
                                      "overflow")):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert got[0].shape == (8, 25, k, 2)
    assert bool(got[2].any())
    if k == 512:
        assert not bool(got[3].any())
    else:
        assert bool(got[3].any())


def test_the_body25_pipelines_graphs_replay_its_eager_programs(card):
    sd = body25_state_dict(np.random.default_rng(25), body25.TRUNK_WIDTHS,
                           body25.STAGE_WIDTHS)
    det = convert_retinaface(random_retinaface_state_dict(
        np.random.default_rng(33)))
    pipe = PerceptionPipeline(
        det_params=det, pose_params=convert_body25(sd), pose="body25",
        with_embeddings=False, device=card, compute_dtype=torch.bfloat16,
        pose_short_side=368, max_peaks=16, max_escalations=0)
    gen = np.random.default_rng(7)
    batches = [gen.integers(0, 256, (4, 540, 960, 3), dtype=np.uint8)
               for _ in range(3)]
    pipe.warmup(4, 540, 960)
    assert pipe._graphs
    tables = []
    original = pipeline_module.assemble_humans

    def recording(coords, scores, valid, reg, accept, *args, **kwargs):
        tables.append([np.array(a) for a in (coords, scores, valid, reg,
                                             accept)])
        return original(coords, scores, valid, reg, accept, *args, **kwargs)

    pipeline_module.assemble_humans = recording
    try:
        pipe.graph_calls = {"replayed": 0, "eager": 0}
        got = list(pipe.process_stream(batches, depth=2))
        assert pipe.graph_calls["eager"] == 0
        replayed, tables_got = pipe.graph_calls["replayed"], tables[:]
        tables.clear()
        pipe._graphs = {}
        want = list(pipe.process_stream(batches, depth=2))
    finally:
        pipeline_module.assemble_humans = original
    assert replayed >= 3 * len(batches)
    assert len(tables_got) == len(tables) == 12
    assert sum(int(t[2].sum()) for t in tables) > 0
    for a, b in zip(tables_got, tables):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for g, w in zip(got, want):
        for pg, pw in zip(g["poses"], w["poses"]):
            assert len(pg) == len(pw)
            for a, b in zip(pg, pw):
                np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
