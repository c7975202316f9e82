"""Cairo renderer for annotation scenes (optional extra).

Chosen by ``terran_tpu_torch.vis.backend`` when pycairo imports;
Pillow otherwise.
Drawing semantics match the reference backend
(terran/vis/cairo.py): rounded boxes with dashed
crosshairs for faces, filled bezier ribbons for limbs, round dots for
keypoints. All face/pose -> primitive lowering lives in
``terran_tpu_torch.vis.scene``; this module only rasterises primitives.
"""

import math

import cairo
import numpy as np

from terran_tpu_torch.vis import scene

_TURN = 2 * math.pi
_QUARTER = math.pi / 2


def _unit(rgb):
    return tuple(channel / 255 for channel in rgb)


class CairoCanvas:
    """Cairo context over a BGRA view of an RGB uint8 array.

    Cairo's RGB24 surfaces are BGRA in memory, so the image is expanded to
    a 4-channel buffer with the channel order reversed; ``finish`` strips
    the alpha plane and flips the channels back.
    """

    def __init__(self, image):
        height, width = image.shape[:2]
        self.scale = scene.marker_scale(height, width)

        alpha = np.full((height, width, 1), 255, dtype=np.uint8)
        self._buffer = np.concatenate([image[..., ::-1], alpha], axis=2)
        surface = cairo.ImageSurface.create_for_data(
            self._buffer, cairo.Format.RGB24, width, height
        )
        self._ctx = cairo.Context(surface)
        self._ctx.select_font_face(
            "DejaVuSans-Bold",
            cairo.FONT_SLANT_NORMAL,
            cairo.FONT_WEIGHT_NORMAL,
        )
        self._ctx.set_font_size(int(16 * self.scale))

    def finish(self):
        return self._buffer[..., 2::-1]

    def marker(self, face):
        ctx, s = self._ctx, self.scale
        x0, y0, x1, y1 = face.bbox
        r = 10.0 * s

        ctx.set_source_rgba(*_unit(face.color), 1.0)

        # Box outline: four corner arcs joined into one rounded rectangle.
        ctx.set_dash([])
        ctx.set_line_width(3.0 * s)
        ctx.new_sub_path()
        ctx.arc(x1 - r, y0 + r, r, -_QUARTER, 0)
        ctx.arc(x1 - r, y1 - r, r, 0, _QUARTER)
        ctx.arc(x0 + r, y1 - r, r, _QUARTER, 2 * _QUARTER)
        ctx.arc(x0 + r, y0 + r, r, 2 * _QUARTER, 3 * _QUARTER)
        ctx.close_path()
        ctx.stroke()

        # Dashed crosshair through the box centre.
        ctx.set_dash([10.0 * s])
        ctx.set_line_width(1.0 * s)
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        ctx.move_to(cx, y0)
        ctx.line_to(cx, y1)
        ctx.move_to(x0, cy)
        ctx.line_to(x1, cy)
        ctx.stroke()

        if face.tag is not None:
            ctx.move_to(x0 + 3 * s, y0 + 15 * s)
            ctx.show_text(face.tag)

    def limb(self, limb):
        ctx, s = self._ctx, self.scale
        (xa, ya), (xb, yb) = limb.src, limb.dst

        # Offset each endpoint perpendicular to the limb by half-width w,
        # and fill the closed curve through the four offset points — a
        # ribbon that tapers via the bezier control points.
        w = 4 * s
        dy = yb - ya
        if abs(dy) > 0:
            slope = -(xb - xa) / dy
            ox = w / math.sqrt(slope * slope + 1)
            oy = ox * slope
        else:
            ox, oy = 0, w

        ctx.set_source_rgba(*_unit(limb.color), 0.7)
        ctx.set_line_width(1.0)
        ctx.move_to(xa, ya)
        ctx.curve_to(int(xa + ox), int(ya + oy),
                     int(xb + ox), int(yb + oy), xb, yb)
        ctx.curve_to(int(xb - ox), int(yb - oy),
                     int(xa - ox), int(ya - oy), xa, ya)
        ctx.fill()
        ctx.stroke()

    def dot(self, dot):
        ctx = self._ctx
        ctx.set_source_rgba(*_unit(dot.color), 0.9)
        ctx.arc(dot.center[0], dot.center[1], 3 * self.scale, 0, _TURN)
        ctx.fill()
        ctx.stroke()


def vis_faces(image, faces):
    """Render face markers (+ labels) onto a copy of ``image``."""
    canvas = CairoCanvas(image)
    for marker in scene.face_markers(faces):
        canvas.marker(marker)
    return canvas.finish()


def vis_poses(image, poses):
    """Render pose skeletons onto a copy of ``image``."""
    canvas = CairoCanvas(image)
    for limb in scene.pose_limbs(poses):
        canvas.limb(limb)
    for dot in scene.pose_dots(poses):
        canvas.dot(dot)
    return canvas.finish()
