"""The port's ``open_image`` and ``resolve_images`` against
``terran_tpu.io.image``: the same arrays (exact) for PNGs of each mode, a
JPEG and a URL served on 127.0.0.1 (nothing leaves the machine), and the
same paths, in the same order and batches, over a tree with invalid and
nested files."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from terran_tpu.io import image as jax_image
from terran_tpu_torch.io import image
from torch_port_fixtures import LocalServer


def write_image(path, mode, rng, fmt=None):
    rgb = rng.integers(0, 255, (30, 40, 3), dtype=np.uint8)
    picture = Image.fromarray(rgb)
    if mode == "P":
        picture = picture.convert("P", palette=Image.Palette.ADAPTIVE)
    elif mode != "RGB":
        picture = picture.convert(mode)
    picture.save(path, format=fmt)
    return path


@pytest.mark.parametrize("mode,suffix", [("RGB", "png"), ("RGBA", "png"),
                                         ("L", "png"), ("P", "png"),
                                         ("RGB", "jpg")])
def test_open_image_equals_jax(mode, suffix, tmp_path, rng):
    path = write_image(tmp_path / f"x.{suffix}", mode, rng)
    expected = jax_image.open_image(path)
    assert expected.shape == (30, 40, 3) and expected.dtype == np.uint8
    for uri in (path, str(path)):
        got = image.open_image(uri)
        assert got.dtype == expected.dtype
        assert np.array_equal(got, expected)


def test_open_image_expands_the_home_directory(tmp_path, rng, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    write_image(tmp_path / "x.png", "RGB", rng)
    assert np.array_equal(image.open_image("~/x.png"),
                          jax_image.open_image("~/x.png"))


def test_open_image_from_a_url(tmp_path, rng):
    path = write_image(tmp_path / "x.png", "RGBA", rng)
    with LocalServer({"/x.png": [(200, path.read_bytes())]}) as server:
        got = image.open_image(server.url("/x.png"))
        expected = jax_image.open_image(server.url("/x.png"))
        assert server.requests == [("/x.png", image.USER_AGENT)] * 2
    assert image.USER_AGENT == jax_image.USER_AGENT
    assert np.array_equal(got, expected)
    assert np.array_equal(got, jax_image.open_image(path))


@pytest.fixture
def tree(tmp_path, rng):
    """Images at several depths, beside files PIL rejects and a
    directory named like an image."""
    root = tmp_path / "gallery"
    for rel in ("a.png", "b.jpg", "sub/c.png", "sub/deeper/d.png",
                "sub/e.png", "z.png"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        write_image(root / rel, "RGB", rng)
    (root / "notes.txt").write_text("not an image")
    (root / "sub" / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nbroken")
    (root / "dir.png").mkdir()
    return root


@pytest.mark.parametrize("batch_size", [None, 1, 2, 3])
def test_resolve_images_equals_jax(batch_size, tree):
    expected = list(jax_image.resolve_images(tree, batch_size=batch_size))
    for root in (tree, str(tree)):
        got = list(image.resolve_images(root, batch_size=batch_size))
        assert got == expected
    flat = expected if batch_size is None else sum(expected, [])
    assert [p.relative_to(tree).as_posix() for p in flat] == [
        "a.png", "b.jpg", "sub/c.png", "sub/deeper/d.png", "sub/e.png",
        "z.png"]
    if batch_size is not None:
        assert all(isinstance(p, Path) for p in flat)
        assert [len(b) for b in expected][-1] == (6 % batch_size
                                                  or batch_size)
