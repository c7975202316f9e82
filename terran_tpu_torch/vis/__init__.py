"""Visualization, copied from ``terran_tpu/vis``: colormaps, marker
scaling, the pose connection topology and its colour scheme,
``display_image``, and ``vis_faces``/``vis_poses``.

The JAX package picks its backend when it is imported. Here the choice
waits for the first ``vis_faces``/``vis_poses`` call: Cairo when pycairo
imports, Pillow otherwise, and ``ImportError`` when neither does. So
importing this package needs neither; only drawing does.
"""

import functools
import random
from io import BytesIO
from subprocess import SubprocessError, run

import numpy as np

from terran_tpu_torch.pose import Keypoint

# Marker scale by image area (largest matching area wins).
MARKER_SCALES = [
    (1920 * 1080, 1.8),
    (1280 * 720, 1.5),
    (480 * 360, 1.3),
    (0, 1),
]


def display_image(image):
    """Show an image with `feh`, falling back to matplotlib."""
    from PIL import Image

    if isinstance(image, np.ndarray):
        image = Image.fromarray(image)

    buf = BytesIO()
    image.save(buf, format="png")

    try:
        run(["feh", "-"], input=buf.getvalue())
        return
    except (FileNotFoundError, SubprocessError):
        pass

    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise Exception(
            "Unable to find a suitable backend to display an image. "
            "Tried `feh` and `matplotlib`. Install either in order to use "
            "this function."
        )
    plt.imshow(image)
    plt.show()


def hex_to_rgb(code):
    return tuple(int(code[i: i + 2], 16) for i in (0, 2, 4))


# The default 10-colour categorical d3 palette.
_D3_PALETTE = [
    "1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd",
    "8c564b", "e377c2", "7f7f7f", "bcbd22", "17becf",
]


def build_colormap():
    """Label -> colour mapping with memory: the same label always maps to
    the same colour; unseen labels take the next palette entry; ``None``
    draws a random colour."""
    colors = [hex_to_rgb(code) for code in _D3_PALETTE]
    assigned = {}

    def colormap(label=None):
        if label is None:
            return random.choice(colors)
        if label not in assigned:
            assigned[label] = colors[len(assigned) % len(colors)]
        return assigned[label]

    return colormap


FACE_COLORMAP = build_colormap()


# Pose skeleton: (connection, connection colour) pairs in draw order, plus
# a colour per keypoint. Head warm-toned, right side greens/reds, left side
# blues/ochres.
_K = Keypoint
_SKELETON = [
    ((_K.NOSE, _K.NECK), "e6550d"),
    ((_K.NOSE, _K.R_EYE), "fd8d3c"),
    ((_K.R_EYE, _K.R_EAR), "fdae6b"),
    ((_K.NOSE, _K.L_EYE), "843c39"),
    ((_K.L_EYE, _K.L_EAR), "ad494a"),

    ((_K.NECK, _K.R_SHOULDER), "637939"),
    ((_K.R_SHOULDER, _K.R_ELBOW), "8ca252"),
    ((_K.R_ELBOW, _K.R_HAND), "b5cf6b"),
    ((_K.NECK, _K.R_HIP), "843c39"),
    ((_K.R_HIP, _K.R_KNEE), "ad494a"),
    ((_K.R_KNEE, _K.R_FOOT), "d6616b"),

    ((_K.NECK, _K.L_SHOULDER), "3182bd"),
    ((_K.L_SHOULDER, _K.L_ELBOW), "6baed6"),
    ((_K.L_ELBOW, _K.L_HAND), "9ecae1"),
    ((_K.NECK, _K.L_HIP), "8c6d31"),
    ((_K.L_HIP, _K.L_KNEE), "bd9e39"),
    ((_K.L_KNEE, _K.L_FOOT), "e7ba52"),
]

POSE_CONNECTIONS = [conn for conn, _ in _SKELETON]
POSE_CONNECTION_COLORS = [hex_to_rgb(code) for _, code in _SKELETON]

_KEYPOINT_COLOR_CODES = {
    _K.NOSE: "e6550d", _K.NECK: "fd8d3c",
    _K.R_EYE: "fdae6b", _K.L_EYE: "843c39",
    _K.R_EAR: "ad494a", _K.L_EAR: "d6616b",
    _K.R_SHOULDER: "637939", _K.R_ELBOW: "8ca252", _K.R_HAND: "b5cf6b",
    _K.R_HIP: "843c39", _K.R_KNEE: "ad494a", _K.R_FOOT: "d6616b",
    _K.L_SHOULDER: "3182bd", _K.L_ELBOW: "6baed6", _K.L_HAND: "9ecae1",
    _K.L_HIP: "8c6d31", _K.L_KNEE: "bd9e39", _K.L_FOOT: "e7ba52",
}
POSE_KEYPOINT_COLORS = {
    kp: hex_to_rgb(code) for kp, code in _KEYPOINT_COLOR_CODES.items()
}


@functools.cache
def backend():
    """The renderer module: ``vis.cairo`` when pycairo imports, else
    ``vis.pillow``; ``ImportError`` when neither Pillow nor pycairo does.
    A failed choice is not cached, so installing one later works."""
    try:
        from terran_tpu_torch.vis import cairo as renderer
    except ImportError:
        try:
            from terran_tpu_torch.vis import pillow as renderer
        except ImportError as exc:
            raise ImportError(
                "vis_faces and vis_poses need Pillow or pycairo, and "
                "neither imports"
            ) from exc
    return renderer


def vis_faces(image, faces, **kwargs):
    """Render face markers (+ labels) onto a copy of ``image`` with the
    backend's ``vis_faces`` (Pillow's takes ``scale``)."""
    return backend().vis_faces(image, faces, **kwargs)


def vis_poses(image, poses, **kwargs):
    """Render pose skeletons onto a copy of ``image`` with the backend's
    ``vis_poses`` (Pillow's takes ``scale``)."""
    return backend().vis_poses(image, poses, **kwargs)
