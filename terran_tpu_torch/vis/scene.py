"""Backend-neutral annotation scene builder, copied from
``terran_tpu/vis/scene.py``. The face colormap is read from
``terran_tpu_torch.vis`` at each call, so that replacing
``vis.FACE_COLORMAP`` takes effect.

The reference implements face/pose drawing twice, once per backend
(terran/vis/cairo.py, pillow.py), duplicating the label
selection, colormap lookup and visibility logic. Here that logic lives in
one place: faces and poses are lowered to a flat list of primitive draw
commands (markers, labels, limbs, dots) and each backend is a dumb renderer
over those primitives. Colours are resolved here; geometry stays in image
coordinates and the backend applies its own stroke widths / alpha.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

from terran_tpu_torch import vis
from terran_tpu_torch.pose import Keypoint
from terran_tpu_torch.vis import (
    MARKER_SCALES, POSE_CONNECTIONS, POSE_CONNECTION_COLORS,
    POSE_KEYPOINT_COLORS,
)

RGB = Tuple[int, int, int]


@dataclass(frozen=True)
class FaceMarker:
    """One detected face: a box plus an optional text tag."""
    bbox: Tuple[float, float, float, float]   # x_min, y_min, x_max, y_max
    color: RGB
    tag: Optional[str]


@dataclass(frozen=True)
class Limb:
    """A skeleton connection between two visible keypoints."""
    src: Tuple[float, float]
    dst: Tuple[float, float]
    color: RGB


@dataclass(frozen=True)
class Dot:
    """A single visible keypoint."""
    center: Tuple[float, float]
    color: RGB


def marker_scale(height, width):
    """Marker scale factor for an image: the largest-area bracket in
    MARKER_SCALES that the image fills."""
    area = height * width
    for threshold, scale in MARKER_SCALES:
        if area >= threshold:
            return scale
    return MARKER_SCALES[-1][1]


def _as_sequence(objects):
    if isinstance(objects, (list, tuple)):
        return objects
    return [objects]


def face_markers(faces):
    """Lower face dicts to FaceMarker primitives.

    Colour identity follows ``name`` (falling back to ``track``) so the
    same person keeps the same colour across frames; the visible tag
    prefers an explicit ``text``, then ``#<track>``.
    """
    markers = []
    for face in _as_sequence(faces):
        identity = face.get("name") or face.get("track")
        if face.get("text") is not None:
            tag = str(face["text"])
        elif face.get("track") is not None:
            tag = "#{}".format(face["track"])
        else:
            tag = None
        x_min, y_min, x_max, y_max = (float(v) for v in face["bbox"])
        markers.append(FaceMarker(
            bbox=(x_min, y_min, x_max, y_max),
            color=tuple(vis.FACE_COLORMAP(identity)),
            tag=tag,
        ))
    return markers


def pose_limbs(poses):
    """Lower pose dicts to Limb primitives (skeleton draw order)."""
    limbs = []
    for pose in _as_sequence(poses):
        points = pose["keypoints"]
        for index, (part_a, part_b) in enumerate(POSE_CONNECTIONS):
            xa, ya, a_visible = points[part_a.value]
            xb, yb, b_visible = points[part_b.value]
            if a_visible and b_visible:
                limbs.append(Limb(
                    src=(float(xa), float(ya)),
                    dst=(float(xb), float(yb)),
                    color=POSE_CONNECTION_COLORS[index],
                ))
    return limbs


def pose_dots(poses):
    """Lower pose dicts to Dot primitives (one per visible keypoint)."""
    dots = []
    for pose in _as_sequence(poses):
        for index, (x, y, visible) in enumerate(pose["keypoints"]):
            if visible:
                dots.append(Dot(
                    center=(float(x), float(y)),
                    color=POSE_KEYPOINT_COLORS[Keypoint(index)],
                ))
    return dots
