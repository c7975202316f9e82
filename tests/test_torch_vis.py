"""The port's ``vis`` against ``terran_tpu.vis``: the Pillow renderer pixel
for pixel (``np.array_equal``) on faces and poses of several kinds, on
two image sizes and on the port's own detections; the colormap, the
skeleton and ``display_image``.

The face colormap keeps state across calls (a label keeps its colour,
new labels take the next palette entry, no label draws
``random.choice``), so each test gives both packages a fresh colormap and
seeds ``random`` before each side.
"""

import random

import numpy as np
import pytest

import terran_tpu.vis as jax_vis
import terran_tpu.vis.pillow as jax_pillow
import terran_tpu.vis.scene as jax_scene
import terran_tpu_torch.vis as vis
import terran_tpu_torch.vis.pillow as pillow
from terran_tpu_torch.face.detection import RetinaFaceDetector
from terran_tpu_torch.utils.convert import convert_retinaface
from torch_oracle import random_retinaface_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_colormaps(monkeypatch):
    monkeypatch.setattr(vis, "FACE_COLORMAP", vis.build_colormap())
    monkeypatch.setattr(jax_scene, "FACE_COLORMAP",
                        jax_vis.build_colormap())


def draw_both(port_fn, jax_fn, image, objects, seed=0, **kwargs):
    random.seed(seed)
    got = port_fn(image, objects, **kwargs)
    random.seed(seed)
    expected = jax_fn(image, objects, **kwargs)
    assert got.shape == image.shape and got.dtype == np.uint8
    assert np.array_equal(got, expected)
    return got


SIZES = {"100x120": ((100, 120), 1.0), "1080x1920": ((1080, 1920), 1.8)}


def face_cases(height, width):
    sy, sx = height / 100, width / 120
    box = lambda x0, y0, x1, y1: np.array(  # noqa: E731
        [x0 * sx, y0 * sy, x1 * sx, y1 * sy])
    return {
        "tracked": [{"bbox": box(10, 10, 60, 60), "score": 0.9, "track": 7},
                    {"bbox": box(50, 40, 90, 95), "score": 0.8,
                     "track": 12}],
        "named": [{"bbox": box(70, 20, 110, 80), "score": 0.8,
                   "name": "alice", "text": "Alice"},
                  {"bbox": box(5, 30, 45, 70), "score": 0.7,
                   "name": "bob"}],
        "unlabelled": [{"bbox": box(20, 20, 50, 50), "score": 0.6},
                       {"bbox": box(60, 10, 100, 40), "score": 0.5}],
        "inverted corners": [{"bbox": box(60, 60, 10, 10), "score": 0.9,
                              "track": 3}],
        "single dict": {"bbox": box(10, 10, 60, 60), "score": 0.9,
                        "name": "carol"},
    }


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("case", list(face_cases(100, 120)))
def test_vis_faces_pixel_equal(case, size, rng):
    (height, width), scale = SIZES[size]
    image = rng.integers(0, 255, (height, width, 3), dtype=np.uint8)
    faces = face_cases(height, width)[case]
    for seed in (0, 1):  # the second call sees the colormap's history
        out = draw_both(pillow.vis_faces, jax_pillow.vis_faces, image, faces,
                        seed=seed, scale=scale)
        assert (out != image).any()


def poses(height, width, visible, rng):
    keypoints = np.zeros((18, 3), np.int32)
    keypoints[:, 0] = rng.integers(0, width, 18)
    keypoints[:, 1] = rng.integers(0, height, 18)
    keypoints[:visible, 2] = 1
    return [{"keypoints": keypoints, "score": 1.0}]


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("visible", [0, 2, 18])
def test_vis_poses_pixel_equal(visible, size, rng):
    (height, width), scale = SIZES[size]
    image = rng.integers(0, 255, (height, width, 3), dtype=np.uint8)
    people = poses(height, width, visible, rng) \
        + poses(height, width, visible, rng)
    out = draw_both(pillow.vis_poses, jax_pillow.vis_poses, image, people,
                    scale=scale)
    assert (out != image).any() == (visible > 0)


def test_public_functions_pick_the_same_backend(rng):
    image = rng.integers(0, 255, (100, 120, 3), dtype=np.uint8)
    draw_both(vis.vis_faces, jax_vis.vis_faces, image,
              face_cases(100, 120)["tracked"])
    draw_both(vis.vis_poses, jax_vis.vis_poses, image,
              poses(100, 120, 18, rng))
    expected = "cairo" if jax_vis.vis_faces.__module__.endswith("cairo") \
        else "pillow"
    assert vis.backend().__name__ == f"terran_tpu_torch.vis.{expected}"


def test_vis_faces_on_the_ports_detections(rng):
    """The port's own ``RetinaFaceDetector`` output on the CPU, drawn by
    both packages (random weights: boxes partly outside the frame)."""
    detector = RetinaFaceDetector(
        params=convert_retinaface(random_retinaface_state_dict(
            np.random.default_rng(4))),
        device="cpu", top_k=32)
    images = rng.integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    for image, faces in zip(images, detector.call(images)):
        assert faces
        out = draw_both(pillow.vis_faces, jax_pillow.vis_faces, image,
                        faces)
        assert (out != image).any()
        tracked = [dict(face, track=i) for i, face in enumerate(faces)]
        draw_both(pillow.vis_faces, jax_pillow.vis_faces, image, tracked,
                  scale=1.3)


def test_colormap_and_skeleton_equal_jax():
    assert vis.hex_to_rgb("ff0080") == (255, 0, 128)
    port, jax = vis.build_colormap(), jax_vis.build_colormap()
    labels = ["a", "b", "a", 3, "c"] + [f"l{i}" for i in range(12)]
    assert [port(label) for label in labels] \
        == [jax(label) for label in labels]
    random.seed(5)
    drawn = [port() for _ in range(8)]
    random.seed(5)
    assert drawn == [jax() for _ in range(8)]
    assert vis.MARKER_SCALES == jax_vis.MARKER_SCALES
    assert [(a.value, b.value) for a, b in vis.POSE_CONNECTIONS] \
        == [(a.value, b.value) for a, b in jax_vis.POSE_CONNECTIONS]
    assert vis.POSE_CONNECTION_COLORS == jax_vis.POSE_CONNECTION_COLORS
    assert {k.value: c for k, c in vis.POSE_KEYPOINT_COLORS.items()} \
        == {k.value: c for k, c in jax_vis.POSE_KEYPOINT_COLORS.items()}
    from terran_tpu_torch.vis.scene import marker_scale

    for shape in ((1080, 1920), (720, 1280), (360, 480), (10, 10)):
        assert marker_scale(*shape) == jax_scene.marker_scale(*shape)


def test_display_image_uses_feh_then_matplotlib(monkeypatch, rng):
    calls = []

    def fake_run(cmd, input=None):
        calls.append((cmd, input[:8]))

    monkeypatch.setattr("terran_tpu_torch.vis.run", fake_run)
    vis.display_image(rng.integers(0, 255, (4, 4, 3), dtype=np.uint8))
    assert calls == [(["feh", "-"], b"\x89PNG\r\n\x1a\n")]

    shown = []

    def no_feh(cmd, input=None):
        raise FileNotFoundError(cmd[0])

    import matplotlib.pyplot as plt

    monkeypatch.setattr("terran_tpu_torch.vis.run", no_feh)
    monkeypatch.setattr(plt, "show", lambda: shown.append(True))
    vis.display_image(rng.integers(0, 255, (4, 4, 3), dtype=np.uint8))
    assert shown == [True]
    plt.close("all")


def test_cairo_backend_pixel_equal(rng):
    """Where pycairo is installed (the `cairo` extra), the port's Cairo
    renderer draws what the JAX package's does."""
    pytest.importorskip("cairo")
    import terran_tpu.vis.cairo as jax_cairo
    import terran_tpu_torch.vis.cairo as cairo

    image = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    faces = face_cases(120, 160)
    for case in ("tracked", "named", "unlabelled", "single dict"):
        out = draw_both(cairo.vis_faces, jax_cairo.vis_faces, image,
                        faces[case])
        assert (out != image).any()
    draw_both(cairo.vis_poses, jax_cairo.vis_poses, image,
              poses(120, 160, 18, rng))
