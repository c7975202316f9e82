"""Port's pose decode (peaks, limb scores, host assembly) vs the JAX package.

Fields are the smooth random heatmaps/PAFs of test_pose_full_parity.py.
Peaks and accept flags compare exactly; ``reg`` to rtol 1e-4 / atol 1e-5
(its 10-sample sum may run in another order than XLA's, and XLA's CPU sqrt
can differ by an ulp); final keypoints exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

from terran_tpu.ops import pose_decode as jax_decode
from terran_tpu.pose.assembly import assemble_humans as jax_assemble
from terran_tpu.pose.assembly import get_keypoints as jax_get_keypoints
from terran_tpu_torch.ops.pose_decode import (
    COCO_18, find_peaks, limb_scores, pack_peaks, unpack_pose_outputs,
)
from terran_tpu_torch.pose.assembly import assemble_humans, get_keypoints
from torch_port_fixtures import single_torch_thread  # noqa: F401


def smooth_fields(rng, h=64, w=80):
    heat = gaussian_filter(
        rng.normal(scale=1.0, size=(h, w, 19)).astype(np.float32),
        sigma=(4, 4, 0),
    ) * 4.0
    pafs = gaussian_filter(
        rng.normal(scale=1.0, size=(h, w, 38)).astype(np.float32),
        sigma=(6, 6, 0),
    ) * 6.0
    return heat, pafs


def both_peaks(heat, max_peaks):
    exp = tuple(map(np.asarray, jax_decode.find_peaks(
        jnp.asarray(heat), 0.1, max_peaks
    )))
    got = tuple(t.numpy() for t in find_peaks(
        torch.from_numpy(heat), 0.1, max_peaks
    ))
    return exp, got


@pytest.mark.parametrize("max_peaks", [64, 4])
def test_find_peaks_matches_jax(max_peaks, rng):
    heat, _ = smooth_fields(rng)
    heat = heat[..., :COCO_18.parts]
    exp, got = both_peaks(heat, max_peaks)
    for e, g in zip(exp, got):
        np.testing.assert_array_equal(e, g)


def test_find_peaks_plateau_tie_order():
    """Exact ties: the kept set takes the earlier row-major positions
    (jax.lax.top_k's order), then sorts row-major."""
    heat = np.zeros((12, 14, 2), np.float32)
    heat[2:10, 3:12, :] = 0.9      # a flat plateau: every interior pixel
    exp, got = both_peaks(heat, 5)
    for e, g in zip(exp, got):
        np.testing.assert_array_equal(e, g)
    assert got[3].all()            # saturated


def test_limb_scores_and_keypoints_match_jax(rng):
    for trial in range(3):
        heat, pafs = smooth_fields(rng)
        exp_peaks, (coords, scores, valid, overflow) = both_peaks(
            heat[..., :COCO_18.parts], 64
        )
        reg_e, acc_e = map(np.array, jax_decode.limb_scores(
            jnp.array(pafs), jnp.array(coords), jnp.array(valid), 0.05
        ))
        reg_g, acc_g = (t.numpy() for t in limb_scores(
            torch.from_numpy(pafs), torch.from_numpy(coords),
            torch.from_numpy(valid), 0.05,
        ))
        np.testing.assert_array_equal(acc_e, acc_g)
        np.testing.assert_allclose(reg_g, reg_e, rtol=1e-4, atol=1e-5)

        args = (coords, scores, valid, reg_g, acc_g)
        peaks_e, humans_e = jax_assemble(*args, use_native=False)
        peaks_g, humans_g = assemble_humans(*args)
        np.testing.assert_array_equal(peaks_e, peaks_g)
        np.testing.assert_array_equal(humans_e, humans_g)
        kp_e = jax_get_keypoints(peaks_e, humans_e, scale=0.5)
        kp_g = get_keypoints(peaks_g, humans_g, scale=0.5)
        assert len(kp_e) == len(kp_g) > 0, trial
        for e, g in zip(kp_e, kp_g):
            np.testing.assert_array_equal(e["keypoints"], g["keypoints"])
            assert e["score"] == g["score"]


def test_batched_limb_scores_equal_per_image(rng):
    fields = [smooth_fields(rng, 32, 40) for _ in range(2)]
    heat = torch.from_numpy(
        np.stack([f[0] for f in fields]))[..., :COCO_18.parts]
    pafs = torch.from_numpy(np.stack([f[1] for f in fields]))
    coords, scores, valid, overflow = find_peaks(heat, 0.1, 16)
    reg, accept = limb_scores(pafs, coords, valid, 0.05)
    for i in range(2):
        c, s, v, o = find_peaks(heat[i], 0.1, 16)
        assert torch.equal(c, coords[i]) and torch.equal(v, valid[i])
        r, a = limb_scores(pafs[i], c, v, 0.05)
        assert torch.equal(r, reg[i]) and torch.equal(a, accept[i])


def test_pack_unpack_round_trip(rng):
    heat, _ = smooth_fields(rng, 32, 40)
    coords, scores, valid, overflow = find_peaks(
        torch.from_numpy(heat[..., :COCO_18.parts]), 0.1, 4
    )
    peaks = pack_peaks(coords, scores, valid, overflow)
    limbs = torch.zeros((19, 4, 4, 2))
    c, s, v, _, _, o = unpack_pose_outputs(peaks.numpy(), limbs.numpy())
    np.testing.assert_array_equal(c, coords.numpy())
    np.testing.assert_array_equal(s, scores.numpy())
    np.testing.assert_array_equal(v, valid.numpy())
    np.testing.assert_array_equal(o, overflow.numpy())
