"""SORT-based face tracking, a copy of ``terran_tpu/tracking/face.py``.

Tracking-by-detection with a 7-state constant-velocity Kalman filter per
face and Hungarian IoU association. Host-side: the state is a handful of
4x4 matrix ops per frame. The JAX package's behaviour is kept as it is:
``face_tracking(video=None)`` uses its resolved ``max_age``/``min_hits``,
zero-area boxes count as no overlap, an empty tracker set gives a (0, 5)
unmatched-tracker array, and ``KalmanTracker`` ids come from a
lock-guarded class counter. The default detector is this package's
``face_detection``.
"""

import threading

import numpy as np
from scipy.optimize import linear_sum_assignment

from terran_tpu_torch.face.detection import Detection, face_detection
from terran_tpu_torch.tracking.kalman import KalmanFilter


def linear_assignment(cost_matrix):
    return np.transpose(np.asarray(linear_sum_assignment(cost_matrix)))


def iou(bbox_1, bbox_2):
    """IoU between two (x1, y1, x2, y2) boxes (ref face.py:14-44)."""
    x_min = np.maximum(bbox_1[0], bbox_2[0])
    y_min = np.maximum(bbox_1[1], bbox_2[1])
    x_max = np.minimum(bbox_1[2], bbox_2[2])
    y_max = np.minimum(bbox_1[3], bbox_2[3])
    intersection = (
        np.maximum(0.0, x_max - x_min) * np.maximum(0.0, y_max - y_min)
    )
    return intersection / (
        (bbox_1[2] - bbox_1[0]) * (bbox_1[3] - bbox_1[1])
        + (bbox_2[2] - bbox_2[0]) * (bbox_2[3] - bbox_2[1])
        - intersection
    )


def corners_to_center(bbox):
    """(x1, y1, x2, y2) -> (x, y, area, ratio) column (ref face.py:47-72)."""
    width = bbox[2] - bbox[0]
    height = bbox[3] - bbox[1]
    x = bbox[0] + width / 2.0
    y = bbox[1] + height / 2.0
    return np.array([x, y, width * height, width / height]).reshape((4, 1))


def center_to_corners(bbox):
    """(x, y, area, ratio) -> (x1, y1, x2, y2) (ref face.py:75-97)."""
    width = np.sqrt(bbox[2] * bbox[3])
    height = bbox[2] / width
    return np.concatenate([
        bbox[0] - width / 2.0,
        bbox[1] - height / 2.0,
        bbox[0] + width / 2.0,
        bbox[1] + height / 2.0,
    ])


class KalmanTracker:
    """Single-face tracker: constant-velocity KF over (x, y, area, ratio)
    with no ratio velocity (ref face.py:100-196)."""

    count = 0
    _count_lock = threading.Lock()

    @classmethod
    def _next_id(cls):
        with cls._count_lock:
            value = cls.count
            cls.count += 1
        return value

    def __init__(self, face):
        self.kf = KalmanFilter(dim_x=7, dim_z=4)

        self.kf.F = np.array([
            [1, 0, 0, 0, 1, 0, 0],
            [0, 1, 0, 0, 0, 1, 0],
            [0, 0, 1, 0, 0, 0, 1],
            [0, 0, 0, 1, 0, 0, 0],
            [0, 0, 0, 0, 1, 0, 0],
            [0, 0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 0, 0, 1],
        ], dtype=float)
        self.kf.H = np.eye(4, 7)

        self.kf.R[2:, 2:] *= 10.0
        self.kf.P[4:, 4:] *= 1000.0  # unobservable initial velocities
        self.kf.P *= 10.0
        self.kf.Q[-1, -1] *= 0.01
        self.kf.Q[4:, 4:] *= 0.01

        self.kf.x[:4] = corners_to_center(face["bbox"])

        self.hits = 0
        self.time_since_update = 0
        self.id = KalmanTracker._next_id()

    def update(self, face):
        self.time_since_update = 0
        self.hits += 1
        self.kf.update(corners_to_center(face["bbox"]))

    def predict(self):
        # Nullify area velocity if the box would invert (ref face.py:189-192).
        if (self.kf.x[6] + self.kf.x[2]) <= 0:
            self.kf.x[6] *= 0.0
        self.kf.predict()
        self.time_since_update += 1
        return center_to_corners(self.kf.x)


def associate_detections_to_trackers(faces, trackers, iou_threshold=0.3):
    """Hungarian assignment with IoU-threshold post-filter
    (ref face.py:199-266)."""
    if not len(trackers):
        return (
            np.empty((0, 2), dtype=int),
            np.arange(len(faces)),
            np.empty((0, 5), dtype=int),
        )
    if not len(faces):
        return (
            np.empty((0, 2), dtype=int),
            np.empty((0,), dtype=int),
            np.arange(len(trackers)),
        )

    # Vectorised IoU matrix (the reference's nested Python loop,
    # tracking/face.py:229-231, is O(faces x tracks) interpreter overhead
    # and dominates crowded scenes).
    fb = np.stack([np.asarray(f["bbox"], dtype=np.float64) for f in faces])
    tb = np.asarray(trackers, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lt = np.maximum(fb[:, None, :2], tb[None, :, :2])
        rb = np.minimum(fb[:, None, 2:4], tb[None, :, 2:4])
        wh = np.clip(rb - lt, 0.0, None)
        inter = wh[..., 0] * wh[..., 1]
        area_f = (fb[:, 2] - fb[:, 0]) * (fb[:, 3] - fb[:, 1])
        area_t = (tb[:, 2] - tb[:, 0]) * (tb[:, 3] - tb[:, 1])
        iou_matrix = inter / (area_f[:, None] + area_t[None, :] - inter)
    # Degenerate zero-area boxes (possible after the int32 coordinate
    # rounding in resize_out) make IoU 0/0 = NaN, which would crash the
    # Hungarian solver — treat them as no overlap. (Latent crash in the
    # reference, tracking/face.py:225-236.)
    iou_matrix = np.nan_to_num(
        iou_matrix, nan=0.0, posinf=0.0, neginf=0.0
    ).astype(np.float32)

    matched_indices = linear_assignment(-iou_matrix)

    unmatched_faces = [
        face_idx for face_idx in range(len(faces))
        if face_idx not in matched_indices[:, 0]
    ]
    unmatched_trackers = [
        track_idx for track_idx in range(len(trackers))
        if track_idx not in matched_indices[:, 1]
    ]

    matches = []
    for face_idx, track_idx in matched_indices:
        if iou_matrix[face_idx, track_idx] < iou_threshold:
            unmatched_faces.append(face_idx)
            unmatched_trackers.append(track_idx)
        else:
            matches.append(np.array([face_idx, track_idx], dtype=int))

    matches = (
        np.stack(matches) if matches else np.empty((0, 2), dtype=int)
    )
    return matches, np.array(unmatched_faces), np.array(unmatched_trackers)


class Sort:
    """SORT lifecycle manager (ref face.py:269-411): max_age eviction,
    min_hits confirmation, optional unmatched passthrough."""

    def __init__(self, max_age=1, min_hits=3, return_unmatched=False):
        self.max_age = max_age
        self.min_hits = min_hits
        self.return_unmatched = return_unmatched
        self.trackers = []
        self.frame_count = 0

    def update(self, faces):
        """Advance one frame with the detected ``faces``; returns the same
        dicts augmented with a ``track`` id (or filtered if unconfirmed)."""
        self.frame_count += 1

        to_delete = []
        tracks = np.zeros((len(self.trackers), 4))
        for track_idx, track in enumerate(tracks):
            position = self.trackers[track_idx].predict()
            track[:] = position
            if np.any(np.isnan(position)):
                to_delete.append(track_idx)

        tracks = np.ma.compress_rows(np.ma.masked_invalid(tracks))
        for t in reversed(to_delete):
            self.trackers.pop(t)

        matched, unmatched_faces, unmatched_tracks = (
            associate_detections_to_trackers(faces, tracks)
        )

        augmented_faces = []

        for track_idx, track in enumerate(self.trackers):
            if track_idx not in unmatched_tracks:
                face_idx = int(
                    matched[np.where(matched[:, 1] == track_idx)[0], 0].item()
                )
                track.update(faces[face_idx])
                track_id = track.id if (
                    track.hits >= self.min_hits
                    or self.frame_count <= self.min_hits
                ) else None
                augmented_faces.append({"track": track_id, **faces[face_idx]})

        for face_idx in unmatched_faces:
            track = KalmanTracker(faces[face_idx])
            self.trackers.append(track)
            track_id = track.id if self.min_hits == 0 else None
            augmented_faces.append({"track": track_id, **faces[face_idx]})

        if not self.return_unmatched:
            augmented_faces = [
                face for face in augmented_faces
                if face["track"] is not None
            ]

        self.trackers = [
            track for track in self.trackers
            if track.time_since_update <= self.max_age
        ]

        return augmented_faces


class FaceTracking:
    """Detector+tracker wrapper behaving like a Detection with an extra
    ``track`` field (ref face.py:414-470)."""

    def __init__(self, detector=None, tracker=None):
        self.detector = detector
        self.tracker = tracker

    def __call__(self, frames):
        expanded = False
        if not isinstance(frames, list) and len(frames.shape) == 3:
            expanded = True
            frames = frames[None]

        faces_per_frame = []
        detections_per_frame = self.detector(frames)
        for detections in detections_per_frame:
            faces_per_frame.append(self.tracker.update(detections))

        return faces_per_frame[0] if expanded else faces_per_frame


def face_tracking(*, video=None, max_age=None, min_hits=None, detector=None,
                  return_unmatched=False):
    """Factory for a :class:`FaceTracking` (ref face.py:473-554).

    Defaults assume 30 fps; a ``video`` derives max_age = one second of
    frames, min_hits = a fifth of a second. Explicit arguments win. (The
    reference built the Sort from ``video.framerate`` directly, crashing
    when ``video is None`` — fixed here.)
    """
    max_age_ = 30
    min_hits_ = 6

    if video is not None:
        max_age_ = video.framerate
        min_hits_ = video.framerate // 5

    if max_age is None:
        max_age = max_age_
    if min_hits is None:
        min_hits = min_hits_

    if detector is None:
        detector = face_detection
    else:
        # The exported ``face_detection`` is a lazy proxy, not a Detection
        # instance; accept exactly it or a real Detection.
        from terran_tpu_torch.face.detection import _LazyDetection

        if not isinstance(detector, (Detection, _LazyDetection)):
            raise ValueError(
                "`detector` must be an instance of "
                "`terran_tpu_torch.face.Detection`."
            )

    sort = Sort(
        max_age=max_age,
        min_hits=min_hits,
        return_unmatched=return_unmatched,
    )
    return FaceTracking(detector=detector, tracker=sort)
