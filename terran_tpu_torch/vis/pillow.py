"""Pillow renderer for annotation scenes (default backend).

Drawing semantics match the reference backend
(terran/vis/pillow.py): rectangle face markers with a
filled label box at the top-left corner, wide translucent limb lines and
round keypoint dots. All face/pose -> primitive lowering lives in
``terran_tpu_torch.vis.scene``; this module only rasterises primitives.
"""

import sys

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from terran_tpu_torch.vis import scene

# Candidate system fonts per platform, tried in order at import time.
_FONT_CANDIDATES = {
    "win32": ("Arial",),
    "linux": ("DejaVuSans-Bold", "DroidSans-Bold"),
    "linux2": ("DejaVuSans-Bold", "DroidSans-Bold"),
    "darwin": ("Menlo", "Helvetica"),
}


def _load_system_font():
    for name in _FONT_CANDIDATES.get(sys.platform, ()):
        try:
            return ImageFont.truetype(name)
        except IOError:
            pass
    return None


_BASE_FONT = _load_system_font()


def _font_at(scale):
    if _BASE_FONT is None:
        return ImageFont.load_default()
    return _BASE_FONT.font_variant(size=round(16 * scale))


def _measure(font, text):
    # Pillow >= 10 removed getsize; getbbox is the portable metric.
    x0, y0, x1, y1 = font.getbbox(str(text))
    return x1 - x0, y1 - y0


class PillowCanvas:
    """RGBA drawing context over a copy of an RGB uint8 array."""

    def __init__(self, image, scale=1.0):
        self._image = Image.fromarray(image)
        self._draw = ImageDraw.Draw(self._image, "RGBA")
        self.scale = scale

    def finish(self):
        return np.asarray(self._image)

    def marker(self, face):
        x0, y0, x1, y1 = face.bbox
        # Degenerate sub-pixel detections can arrive with inverted corners,
        # which PIL rejects — normalise before drawing.
        rect = [min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1)]
        self._draw.rectangle(
            rect, outline=face.color + (255,), width=int(3 * self.scale)
        )
        if face.tag is not None:
            self._tag(face)

    def _tag(self, face):
        font = _font_at(self.scale)
        text_width, _ = _measure(font, face.tag)
        em_width, _ = _measure(font, "M")
        pad = em_width * 0.2
        _, line_height = _measure(font, "Mq")

        x, y = face.bbox[0], face.bbox[1]
        self._draw.rectangle(
            [x, y, x + text_width + 3 * pad, y + line_height * 1.15],
            fill=face.color + (255,),
        )
        self._draw.text([x + pad, y], face.tag, font=font)

    def limb(self, limb):
        width = int(self.scale * 8)
        self._draw.line(
            [int(limb.src[0]), int(limb.src[1]),
             int(limb.dst[0]), int(limb.dst[1])],
            fill=limb.color + (180,), width=width,
        )

    def dot(self, dot):
        radius = int(3 * int(self.scale * 4) / 2)
        x, y = dot.center
        self._draw.ellipse(
            [x - radius, y - radius, x + radius, y + radius],
            fill=dot.color + (225,),
        )


def vis_faces(image, faces, scale=1.0):
    """Render face markers (+ labels) onto a copy of ``image``."""
    canvas = PillowCanvas(image, scale=scale)
    for marker in scene.face_markers(faces):
        canvas.marker(marker)
    return canvas.finish()


def vis_poses(image, poses, scale=1.0):
    """Render pose skeletons onto a copy of ``image``."""
    canvas = PillowCanvas(image, scale=scale)
    for limb in scene.pose_limbs(poses):
        canvas.limb(limb)
    for dot in scene.pose_dots(poses):
        canvas.dot(dot)
    return canvas.finish()
