"""``correct`` at a size this CPU holds: a sound run passes the cell's
limits, and each kind of fault the cells can have fails them: the
control (the reference in the next lower precision, in the program's
place) and an answer altered where the program produces it."""

import numpy as np
import pytest
import torch

from conftest import load, run_tiny

OFFLINE, CAMERAS = "bf16-offline-1080p", "bf16-cameras-1080p"


@pytest.mark.parametrize("workload, seconds", [
    (OFFLINE, 6.0), ("int8-offline-1080p", 8.0), (CAMERAS, 2.0)])
def test_a_sound_run_is_correct(tiny, workload, seconds):
    run, spec = tiny
    out, lines = run_tiny(run, spec, workload, seconds=seconds)
    assert out["correct"], lines
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(load(run.BENCH / "limits"
                                            / f"{workload}.json"))
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", [OFFLINE, "int8-offline-1080p"])
def test_the_control_is_not_correct(tiny, workload):
    run, spec = tiny
    out, lines = run_tiny(run, spec, workload, control=1)
    assert not out["correct"], lines
    failed = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failed, lines


def _shift_landmarks(original):
    def altered(packed):
        boxes, landmarks, scores, mask, overflow = original(packed)
        landmarks = landmarks.copy()
        landmarks[:, 0] += 40.0
        return boxes, landmarks, scores, mask, overflow
    return altered


def _dropped_candidates(original):
    """The pre-selection keeps its best candidate alone."""
    def altered(*args, **kwargs):
        boxes, scores, keep, order, overflow = original(*args, **kwargs)
        scores, keep = scores.clone(), keep.clone()
        scores[:, 1:] = float("-inf")
        keep[:, 1:] = False
        return boxes, scores, keep, order, overflow
    return altered


def _rolled_embeddings(original):
    return lambda features: original(torch.roll(features, 1, dims=-1))


def _raised_peaks(original):
    return lambda coords, scores, valid, overflow: original(
        coords, scores + 0.05, valid, overflow)


def _no_peaks(original):
    return lambda coords, scores, valid, overflow: original(
        coords, scores, torch.zeros_like(valid), overflow)


def _shifted_peaks(original):
    """Peaks moved along x, with the scores of the pixels they left."""
    def altered(coords, scores, valid, overflow):
        coords = coords.clone()
        coords[..., 1] += SHIFT_PX
        return original(coords, scores, valid, overflow)
    return altered


def _flipped_keep(original):
    def altered(boxes, valid, threshold):
        keep = original(boxes, valid, threshold).clone()
        keep[:, 0] = ~keep[:, 0]
        return keep
    return altered


SHIFT_PX = 3
FAULTS = {
    "detection": ("terran_tpu_torch.pipeline", "unpack_detections",
                  _shift_landmarks, "det_coord_gap"),
    "dropped candidates": ("terran_tpu_torch.models.retinaface",
                           "nms_fixed", _dropped_candidates,
                           "det_miss_gap"),
    "embedding": ("terran_tpu_torch.pipeline", "normalize_embeddings",
                  _rolled_embeddings, "emb_cos_gap"),
    "peak scores": ("terran_tpu_torch.pipeline", "pack_peaks",
                    _raised_peaks, "peak_score_gap"),
    "no peaks": ("terran_tpu_torch.pipeline", "pack_peaks", _no_peaks,
                 "peak_miss_gap"),
    "shifted peaks": ("terran_tpu_torch.pipeline", "pack_peaks",
                      _shifted_peaks, "peak_max_gap"),
    "nms": ("terran_tpu_torch.ops.nms", "suppress", _flipped_keep,
            "nms_iou_gap"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        tiny, monkeypatch, fault):
    import importlib

    module, name, alter, number = FAULTS[fault]
    module = importlib.import_module(module)
    monkeypatch.setattr(module, name, alter(getattr(module, name)))
    run, spec = tiny
    out, lines = run_tiny(run, spec, OFFLINE)
    assert not out["correct"], lines
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_peaks_not_recorded_are_not_compared_and_nothing_else_changes(
        tiny, monkeypatch):
    from harness import cell as cellmod

    monkeypatch.setattr(cellmod.PeakRecorder, "install", lambda self: self)
    run, spec = tiny
    out, lines = run_tiny(run, spec, OFFLINE)
    assert out["correct"], lines
    assert out["extra"]["not_compared"] == sorted(run.PEAKS_UNRECORDED)
    assert not set(run.PEAKS_UNRECORDED) & set(out["checks"])
    assert cellmod.PeakRecorder().take(2) is None


def test_a_track_altered_where_it_is_produced_is_not_correct(
        tiny, monkeypatch):
    from terran_tpu_torch.tracking.face import Sort

    original = Sort.update

    def altered(self, faces):
        out = original(self, faces)
        if out and self.frame_count == 2:
            out[0] = dict(out[0], track=10 ** 6)
        return out

    monkeypatch.setattr(Sort, "update", altered)
    run, spec = tiny
    out, lines = run_tiny(run, spec, CAMERAS, seconds=3.0)
    assert not out["correct"], lines
    assert out["checks"]["track_mismatches"]["value"] > 0


def test_the_same_seed_gives_the_same_inputs():
    from harness.cell import make_frames
    from harness.weights import make_state_dict

    a = make_frames(2 ** 31 + 7, 2, 8, 8, "cpu", stream=1)
    assert np.array_equal(a, make_frames(2 ** 31 + 7, 2, 8, 8, "cpu",
                                         stream=1))
    assert not np.array_equal(a, make_frames(2 ** 31 + 8, 2, 8, 8, "cpu",
                                             stream=1))
    w1 = make_state_dict("retinaface", 5, "cpu")
    w2 = make_state_dict("retinaface", 5, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
