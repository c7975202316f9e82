"""SORT (Bewley et al. 2016) as terran's face tracker runs it: a
constant-velocity Kalman filter over (x, y, area, ratio) per face, IoU
association by the Hungarian method, ``max_age`` eviction and
``min_hits`` confirmation. A frozen copy of the reference package's host
code (``tracking/face.py``, ``tracking/kalman.py``), with track ids
counted per tracker instead of per process."""

import numpy as np
from scipy.optimize import linear_sum_assignment


def _to_z(bbox):
    w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
    return np.array([bbox[0] + w / 2.0, bbox[1] + h / 2.0, w * h,
                     w / h]).reshape((4, 1))


def _to_box(x):
    w = np.sqrt(x[2] * x[3])
    h = x[2] / w
    return np.concatenate([x[0] - w / 2.0, x[1] - h / 2.0, x[0] + w / 2.0,
                           x[1] + h / 2.0])


class _Track:
    F = np.array([[1, 0, 0, 0, 1, 0, 0], [0, 1, 0, 0, 0, 1, 0],
                  [0, 0, 1, 0, 0, 0, 1], [0, 0, 0, 1, 0, 0, 0],
                  [0, 0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 0, 1, 0],
                  [0, 0, 0, 0, 0, 0, 1]], dtype=float)
    H = np.eye(4, 7)

    def __init__(self, bbox, track_id):
        self.x = np.zeros((7, 1))
        self.P = np.eye(7)
        self.Q = np.eye(7)
        self.R = np.eye(4)
        self.R[2:, 2:] *= 10.0
        self.P[4:, 4:] *= 1000.0
        self.P *= 10.0
        self.Q[-1, -1] *= 0.01
        self.Q[4:, 4:] *= 0.01
        self.x[:4] = _to_z(bbox)
        self.hits = 0
        self.since_update = 0
        self.id = track_id

    def predict(self):
        if (self.x[6] + self.x[2]) <= 0:
            self.x[6] *= 0.0
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q
        self.since_update += 1
        return _to_box(self.x)

    def update(self, bbox):
        self.since_update = 0
        self.hits += 1
        z = np.asarray(_to_z(bbox), dtype=float).reshape(4, 1)
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        self.P = (np.eye(7) - k @ self.H) @ self.P


def _associate(boxes, tracks, threshold=0.3):
    """(matches (M, 2) [face, track], unmatched faces, unmatched tracks)."""
    if not len(tracks):
        return np.empty((0, 2), int), list(range(len(boxes))), []
    if not len(boxes):
        return np.empty((0, 2), int), [], list(range(len(tracks)))
    fb = np.stack([np.asarray(b, dtype=np.float64) for b in boxes])
    tb = np.asarray(tracks, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lt = np.maximum(fb[:, None, :2], tb[None, :, :2])
        rb = np.minimum(fb[:, None, 2:4], tb[None, :, 2:4])
        wh = np.clip(rb - lt, 0.0, None)
        inter = wh[..., 0] * wh[..., 1]
        area_f = (fb[:, 2] - fb[:, 0]) * (fb[:, 3] - fb[:, 1])
        area_t = (tb[:, 2] - tb[:, 0]) * (tb[:, 3] - tb[:, 1])
        ious = inter / (area_f[:, None] + area_t[None, :] - inter)
    ious = np.nan_to_num(ious, nan=0.0, posinf=0.0,
                         neginf=0.0).astype(np.float32)
    pairs = np.transpose(np.asarray(linear_sum_assignment(-ious)))
    un_f = [i for i in range(len(boxes)) if i not in pairs[:, 0]]
    un_t = [j for j in range(len(tracks)) if j not in pairs[:, 1]]
    matches = []
    for i, j in pairs:
        if ious[i, j] < threshold:
            un_f.append(i)
            un_t.append(j)
        else:
            matches.append([i, j])
    return np.array(matches, int).reshape(-1, 2), un_f, un_t


class Sort:
    """One stream's tracker. :meth:`update` takes a frame's face boxes
    and returns [(face index, track id)] of the confirmed faces, in the
    order the published tracker lists them."""

    def __init__(self, max_age, min_hits):
        self.max_age, self.min_hits = max_age, min_hits
        self.tracks, self.frames, self.next_id = [], 0, 0

    def update(self, boxes):
        self.frames += 1
        pred = np.zeros((len(self.tracks), 4))
        drop = []
        for t, row in enumerate(pred):
            row[:] = self.tracks[t].predict()
            if np.any(np.isnan(row)):
                drop.append(t)
        pred = np.ma.compress_rows(np.ma.masked_invalid(pred))
        for t in reversed(drop):
            self.tracks.pop(t)
        matches, un_f, un_t = _associate(boxes, pred)
        out = []
        for t, track in enumerate(self.tracks):
            if t not in un_t:
                face = int(matches[np.where(matches[:, 1] == t)[0], 0].item())
                track.update(boxes[face])
                confirmed = (track.hits >= self.min_hits
                             or self.frames <= self.min_hits)
                if confirmed:
                    out.append((face, track.id))
        for face in un_f:
            track = _Track(boxes[face], self.next_id)
            self.next_id += 1
            self.tracks.append(track)
            if self.min_hits == 0:
                out.append((face, track.id))
        self.tracks = [t for t in self.tracks
                       if t.since_update <= self.max_age]
        return out
