"""The port's SORT face tracking (``terran_tpu_torch.tracking``).

The cases of ``tests/test_tracking.py`` run against the port's modules,
then the port is held to ``terran_tpu.tracking`` on the same seeded
inputs: IoU, the box round trip, the Kalman filter, the association
(zero-area and NaN boxes, no trackers, no faces) and 30-frame ``Sort``
runs with births and deaths. Both are the same numpy code, so every
output is equal; track ids are compared relative to each package's
``KalmanTracker`` counter at the start of a run, since the two classes
count separately.
"""

import numpy as np
import pytest

from terran_tpu.tracking import face as jax_face
from terran_tpu.tracking.kalman import KalmanFilter as JaxKalmanFilter
from terran_tpu_torch.face.detection import Detection
from terran_tpu_torch.tracking import face as port_face
from terran_tpu_torch.tracking.face import (
    KalmanTracker, Sort, associate_detections_to_trackers, center_to_corners,
    corners_to_center, face_tracking, iou,
)
from terran_tpu_torch.tracking.kalman import KalmanFilter


def _face(x1, y1, x2, y2, score=0.9):
    return {
        "bbox": np.array([x1, y1, x2, y2], dtype=np.float64),
        "landmarks": np.zeros((5, 2), np.int32),
        "score": score,
    }


# The cases of tests/test_tracking.py, on the port.

def test_iou_values():
    a = np.array([0, 0, 10, 10])
    assert iou(a, a) == 1.0
    assert iou(a, np.array([20, 20, 30, 30])) == 0.0
    np.testing.assert_allclose(iou(a, np.array([0, 5, 10, 15])), 50 / 150)


def test_corners_center_roundtrip():
    bbox = np.array([10.0, 20.0, 50.0, 100.0])
    center = corners_to_center(bbox)
    np.testing.assert_allclose(center.ravel(), [30, 60, 3200, 0.5])
    np.testing.assert_allclose(center_to_corners(center).ravel(), bbox)


def test_kalman_constant_velocity_convergence():
    kf = KalmanFilter(dim_x=2, dim_z=1)
    kf.F = np.array([[1.0, 1.0], [0.0, 1.0]])
    kf.H = np.array([[1.0, 0.0]])
    for t in range(30):
        kf.predict()
        kf.update([2.0 * (t + 1)])
    assert abs(kf.x[1, 0] - 2.0) < 0.2
    assert abs(kf.x[0, 0] - 60.0) < 1.0


def test_association_matches_and_threshold():
    faces = [_face(0, 0, 10, 10), _face(100, 100, 110, 110)]
    tracks = np.array([[1, 1, 11, 11], [500, 500, 510, 510]])
    matched, unmatched_faces, unmatched_tracks = (
        associate_detections_to_trackers(faces, tracks)
    )
    assert matched.tolist() == [[0, 0]]
    assert 1 in unmatched_faces
    assert 1 in unmatched_tracks


def test_sort_confirms_after_min_hits():
    sort = Sort(max_age=3, min_hits=2)
    assert sort.update([_face(0, 0, 10, 10)]) == []
    out2 = sort.update([_face(1, 1, 11, 11)])
    assert len(out2) == 1 and out2[0]["track"] is not None
    out3 = sort.update([_face(2, 2, 12, 12)])
    assert len(out3) == 1 and out3[0]["track"] == out2[0]["track"]


def test_sort_evicts_after_max_age():
    sort = Sort(max_age=1, min_hits=0)
    track_id = sort.update([_face(0, 0, 10, 10)])[0]["track"]
    assert track_id is not None
    sort.update([])
    sort.update([])
    assert sort.update([_face(0, 0, 10, 10)])[0]["track"] != track_id


def test_sort_keeps_identity_through_motion():
    sort = Sort(max_age=2, min_hits=1)
    ids = []
    for t in range(8):
        out = sort.update([_face(5 * t, 0, 5 * t + 20, 20)])
        if out:
            ids.append(out[0]["track"])
    assert len(set(ids)) == 1


class _FakeDetector(Detection):
    """Stands in for a Detection instance; skips the checkpoint store."""

    def __init__(self):
        pass

    def __call__(self, frames):
        return [[_face(0, 0, 10, 10)] for _ in range(len(frames))]


def test_face_tracking_factory_defaults_without_video():
    tracking = face_tracking(detector=_FakeDetector())
    assert tracking.tracker.max_age == 30
    assert tracking.tracker.min_hits == 6


def test_face_tracking_factory_from_video():
    class FakeVideo:
        framerate = 25

    tracking = face_tracking(video=FakeVideo(), detector=_FakeDetector())
    assert tracking.tracker.max_age == 25
    assert tracking.tracker.min_hits == 5


def test_face_tracking_factory_rejects_bad_detector():
    with pytest.raises(ValueError, match="terran_tpu_torch.face.Detection"):
        face_tracking(detector=object())
    # The JAX package's Detection is not this package's.
    from terran_tpu.face.detection import Detection as JaxDetection

    with pytest.raises(ValueError):
        face_tracking(detector=JaxDetection.__new__(JaxDetection))


def test_face_tracking_end_to_end_on_frames():
    tracking = face_tracking(detector=_FakeDetector(), min_hits=0)
    out = tracking(np.zeros((3, 32, 32, 3), np.uint8))
    assert len(out) == 3
    assert out[0][0]["track"] is not None
    single = tracking(np.zeros((32, 32, 3), np.uint8))
    assert isinstance(single, list) and single[0]["track"] is not None


def test_face_tracking_accepts_lazy_proxy():
    from terran_tpu_torch.face.detection import face_detection as proxy

    tracking = face_tracking(detector=proxy, max_age=5, min_hits=1)
    assert tracking.detector is proxy
    # The default detector is the same proxy, not resolved on creation.
    assert face_tracking().detector is proxy
    assert proxy._instance is None


# Port against the JAX package on seeded inputs.

def random_boxes(rng, n, spread=200.0):
    xy = rng.uniform(0, spread, (n, 2))
    wh = rng.uniform(5, 60, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1)


def test_iou_and_round_trip_match_jax():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 64), random_boxes(rng, 64)
    for x, y in zip(a, b):
        assert iou(x, y) == jax_face.iou(x, y)
        center = corners_to_center(x)
        np.testing.assert_array_equal(center, jax_face.corners_to_center(x))
        np.testing.assert_array_equal(center_to_corners(center),
                                      jax_face.center_to_corners(center))


def test_kalman_filter_matches_jax():
    rng = np.random.default_rng(1)
    filters = [KalmanFilter(dim_x=7, dim_z=4),
               JaxKalmanFilter(dim_x=7, dim_z=4)]
    transition = np.eye(7) + np.eye(7, k=4)
    for kf in filters:
        kf.F = transition.copy()
        kf.H = np.eye(4, 7)
        kf.R[2:, 2:] *= 10.0
    for _ in range(20):
        z = rng.normal(size=4)
        for kf in filters:
            kf.predict()
            kf.update(z)
        np.testing.assert_array_equal(filters[0].x, filters[1].x)
        np.testing.assert_array_equal(filters[0].P, filters[1].P)


def association_cases():
    rng = np.random.default_rng(2)
    faces = [_face(*box) for box in random_boxes(rng, 12, spread=120.0)]
    tracks = random_boxes(rng, 9, spread=120.0)
    zero_area = [_face(10, 10, 10, 30), _face(40, 40, 60, 40)] + faces[:3]
    nan_tracks = tracks.copy()
    nan_tracks[2] = np.nan
    return {
        "random": (faces, tracks),
        "zero-area faces": (zero_area, tracks),
        "zero-area track": (faces, np.vstack([tracks, [[50, 50, 50, 50]]])),
        "NaN track": (faces, nan_tracks),
        "no trackers": (faces, np.zeros((0, 4))),
        "no faces": ([], tracks),
        "neither": ([], np.zeros((0, 4))),
    }


@pytest.mark.parametrize("case", list(association_cases()))
def test_association_matches_jax(case):
    faces, tracks = association_cases()[case]
    got = associate_detections_to_trackers(faces, tracks)
    exp = jax_face.associate_detections_to_trackers(faces, tracks)
    for g, e in zip(got, exp):
        assert g.shape == e.shape and g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)
    if case == "no trackers":
        assert got[2].shape == (0, 5)  # the JAX package's quirk, kept


def random_walk(seed, frames=30):
    """Per frame, int32-rounded faces of a seeded crowd: each face drifts
    and jitters, dies with probability 0.08 a frame and is replaced at
    random; births add faces. Landmarks and scores ride along."""
    rng = np.random.default_rng(seed)
    alive = list(random_boxes(rng, 4, spread=400.0))
    velocity = [rng.normal(0, 3, 2) for _ in alive]
    out = []
    for _ in range(frames):
        keep = [i for i in range(len(alive)) if rng.uniform() > 0.08]
        alive = [alive[i] for i in keep]
        velocity = [velocity[i] for i in keep]
        while rng.uniform() < 0.2:
            alive.append(random_boxes(rng, 1, spread=400.0)[0])
            velocity.append(rng.normal(0, 3, 2))
        faces = []
        for i, (box, v) in enumerate(zip(alive, velocity)):
            alive[i] = box + np.tile(v, 2)
            noisy = alive[i] + rng.normal(0, 1.0, 4)
            faces.append({
                "bbox": np.around(noisy).astype(np.int32),
                "landmarks": rng.integers(0, 400, (5, 2)).astype(np.int32),
                "score": np.float32(rng.uniform(0.5, 1.0)),
            })
        order = rng.permutation(len(faces))
        out.append([faces[i] for i in order])
    return out


def relative_tracks(outputs, base):
    """Each frame's faces as (track id - base or None, bbox, landmarks,
    score) tuples."""
    return [[(None if f["track"] is None else f["track"] - base,
              f["bbox"].tolist(), f["landmarks"].tolist(), float(f["score"]))
             for f in frame] for frame in outputs]


def run_sort(module, sequence, **kwargs):
    """``module.Sort(**kwargs)`` over ``sequence``: per-frame outputs with
    ids relative to the module's counter at the start."""
    base = module.KalmanTracker.count
    sort = module.Sort(**kwargs)
    return relative_tracks([sort.update(faces) for faces in sequence], base)


@pytest.mark.parametrize("min_hits", [0, 3])
@pytest.mark.parametrize("return_unmatched", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_sort_matches_jax(seed, min_hits, return_unmatched):
    sequence = random_walk(seed)
    assert sum(map(len, sequence)) > 60
    kwargs = dict(max_age=2, min_hits=min_hits,
                  return_unmatched=return_unmatched)
    got = run_sort(port_face, sequence, **kwargs)
    assert got == run_sort(jax_face, sequence, **kwargs)
    ids = {f[0] for frame in got for f in frame if f[0] is not None}
    assert len(ids) > 4, "expected births, deaths and several identities"


def test_face_tracking_matches_jax():
    """``FaceTracking`` over a fake detector that replays a random walk:
    the same tracks as the JAX package's."""
    sequence = random_walk(5)

    class Replay(Detection):
        def __init__(self):
            self.frame = 0

        def __call__(self, frames):
            out = sequence[self.frame: self.frame + len(frames)]
            self.frame += len(frames)
            return out

    frames = np.zeros((6, 8, 8, 3), np.uint8)
    bases = (KalmanTracker.count, jax_face.KalmanTracker.count)
    tracking = face_tracking(detector=Replay(), max_age=3, min_hits=2)
    jax_tracking = jax_face.FaceTracking(
        detector=Replay(), tracker=jax_face.Sort(max_age=3, min_hits=2))
    got, exp = [], []
    for _ in range(5):
        got += tracking(frames)
        exp += jax_tracking(frames)
    assert relative_tracks(got, bases[0]) == relative_tracks(exp, bases[1])


def test_id_counter_is_per_class_and_locked():
    """The port's counter is its own: creating port trackers leaves the
    JAX package's count alone, and concurrent creation loses no id."""
    import threading

    jax_count = jax_face.KalmanTracker.count
    start = KalmanTracker.count
    made = []

    def create():
        for _ in range(50):
            made.append(KalmanTracker(_face(0, 0, 10, 10)).id)

    threads = [threading.Thread(target=create) for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=30)
        assert not thread.is_alive()
    assert sorted(made) == list(range(start, start + 200))
    assert jax_face.KalmanTracker.count == jax_count
