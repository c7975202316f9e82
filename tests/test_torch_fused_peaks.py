"""Port's fused upsample + peak scan (plain version, CPU) vs the JAX path.

Ground truth is the JAX package's find_peaks(upsample_bicubic(...)). On the
CPU the port's ``find_peaks_fused`` runs its plain version, which is the
function the CUDA kernel is held to bit for bit on the card. Coords, valid
and overflow compare exactly; scores to 1e-5, as the JAX package's own
fused-vs-XLA tests do.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from terran_tpu.ops.fused_peaks import find_peaks_fused as jax_fused
from terran_tpu.ops.pose_decode import find_peaks as jax_find_peaks
from terran_tpu.ops.upsample import upsample_bicubic as jax_upsample
from terran_tpu_torch.ops.fused_peaks import (
    find_peaks_fused, fused_peaks_enabled, merge_candidates,
)
from torch_port_fixtures import single_torch_thread  # noqa: F401


def reference(heat, threshold, max_peaks):
    ups = jax_upsample(jnp.asarray(heat)[None], 8)[0]
    return tuple(map(np.asarray, jax_find_peaks(ups, threshold, max_peaks)))


def port(heat, threshold, max_peaks):
    return tuple(t.numpy() for t in find_peaks_fused(
        torch.from_numpy(heat), threshold, max_peaks
    ))


def assert_matches(heat, threshold=0.1, max_peaks=16):
    c0, s0, v0, o0 = reference(heat, threshold, max_peaks)
    c1, s1, v1, o1 = port(heat, threshold, max_peaks)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(o0, o1)
    for p in range(heat.shape[-1]):
        n = int(v0[p].sum())
        np.testing.assert_array_equal(c0[p, :n], c1[p, :n])
        np.testing.assert_allclose(s0[p, :n], s1[p, :n], rtol=1e-5)
        # The fused convention: invalid slots carry coords 0, score 0.
        assert (c1[p, n:] == 0).all() and (s1[p, n:] == 0).all()
    return o1


def _bumps(h, w, parts, bumps):
    heat = np.zeros((h, w, parts), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for cy, cx, a, p in bumps:
        heat[..., p] += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)
    return heat


@pytest.mark.parametrize("case", [
    "random", "sparse_bumps", "band_remainder", "saturated"
])
def test_matches_jax_path(case, rng):
    if case == "random":
        heat = rng.normal(scale=0.2, size=(16, 26, 4)).astype(np.float32)
        assert_matches(heat)
    elif case == "sparse_bumps":
        # Off-grid centres: symmetric bumps would make exact ties.
        heat = _bumps(24, 32, 3, [(5.3, 7.6, 0.9, 0), (15.8, 20.1, 0.7, 0),
                                  (10.4, 10.7, 0.8, 1), (19.6, 27.3, 0.6, 2)])
        overflow = assert_matches(heat, max_peaks=8)
        assert not overflow.any()
    elif case == "band_remainder":
        # 21 rows: not a multiple of the kernel's 4-row tiles.
        heat = rng.normal(scale=0.2, size=(21, 19, 2)).astype(np.float32)
        assert_matches(heat)
    else:
        # Noise saturates K=4: strongest 4 kept, re-ordered row-major.
        heat = rng.normal(scale=0.2, size=(16, 26, 3)).astype(np.float32)
        overflow = assert_matches(heat, max_peaks=4)
        assert overflow.all()
        c1, _, _, _ = port(heat, 0.1, 4)
        lin = c1[..., 0].astype(np.int64) * 26 * 8 + c1[..., 1]
        assert (np.diff(lin, axis=-1) > 0).all()


def test_batch_dims(rng):
    heat = rng.normal(scale=0.2, size=(2, 16, 26, 3)).astype(np.float32)
    c, s, v, o = (t.numpy() for t in find_peaks_fused(
        torch.from_numpy(heat), 0.1, 8
    ))
    assert c.shape == (2, 3, 8, 2) and o.shape == (2, 3)
    for b in range(2):
        c0, s0, v0, o0 = reference(heat[b], 0.1, 8)
        np.testing.assert_array_equal(v0, v[b])
        np.testing.assert_array_equal(o0, o[b])
        for p in range(3):
            n = int(v0[p].sum())
            np.testing.assert_array_equal(c0[p, :n], c[b, p, :n])


def test_row_piece_plateau_is_exact():
    """A one-row plateau puts 3+ exact-tie peaks in one (source cell,
    upsampled row) piece. The TPU kernel's per-piece top-2 drops some and
    flags overflow; this port keeps every peak and flags nothing, like the
    JAX XLA path."""
    heat = np.zeros((16, 26, 1), np.float32)
    heat[4, 10:14, 0] = 0.9
    c0, s0, v0, o0 = reference(heat, 0.1, 16)
    c1, s1, v1, o1 = port(heat, 0.1, 16)
    assert not o0[0] and not o1[0]
    np.testing.assert_array_equal(v0, v1)
    n = int(v0.sum())
    np.testing.assert_array_equal(c0[0, :n], c1[0, :n])


def test_matches_pallas_interpret_tiny(rng):
    heat = rng.normal(scale=0.2, size=(8, 10, 2)).astype(np.float32)
    c0, s0, v0, o0 = map(np.asarray, jax_fused(
        jnp.asarray(heat), 0.1, 8, interpret=True
    ))
    c1, s1, v1, o1 = port(heat, 0.1, 8)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(o0, o1)
    np.testing.assert_array_equal(c0, c1)
    np.testing.assert_allclose(s0, s1, rtol=1e-5)


def test_merge_candidates_total_order():
    """The tile merge (the merge kernel's plain version) keeps (score
    desc, index asc) and re-orders row-major; ties go to the smaller index whatever
    tile they come from."""
    inf = float("inf")
    big = 2 ** 31 - 1
    # One plane, two tiles, K = 3 slots each.
    scores = torch.tensor([[[0.5, 0.3, -inf], [0.5, 0.4, 0.3]]])
    lin = torch.tensor([[[70, 5, big], [40, 9, 3]]], dtype=torch.int32)
    counts = torch.tensor([[2, 5]], dtype=torch.int32)
    coords, s, valid, overflow = merge_candidates(scores, lin, counts, 3, 10)
    # Kept: (0.5, 40), (0.5, 70), (0.4, 9); row-major: 9, 40, 70.
    np.testing.assert_array_equal(coords[0].numpy(),
                                  [[0, 9], [4, 0], [7, 0]])
    np.testing.assert_allclose(s[0].numpy(), [0.4, 0.5, 0.5])
    assert valid.all() and bool(overflow[0])


def test_enabled_resolution():
    assert fused_peaks_enabled("on") is True
    assert fused_peaks_enabled("auto") is True
    assert fused_peaks_enabled("off") is False
    with pytest.raises(ValueError):
        fused_peaks_enabled("sometimes")


def test_unsupported_device_raises():
    heat = torch.zeros((8, 8, 1), device="meta")
    with pytest.raises(ValueError, match="no fused_peaks kernel"):
        find_peaks_fused(heat, 0.1, 4)
