"""The CUDA peak kernels' selection and merge, emulated in numpy on the CPU.

``csrc/fused_peaks.cu`` cannot run here, so its two algorithmic halves are
written out in numpy as the kernels do them: the 64-bit key, the scan
kernel's per-tile selection by rank (each candidate counts the larger
keys) and the merge kernel's plane rank (own index plus a binary search
into every other tile's list) and row-major re-order. The emulation must
equal ``merge_candidates`` (the merge's plain version) on the same tile
lists and ``find_peaks_fused_plain`` (the op's plain version) bit for
bit. On the card, ``chip_smoke.py`` holds the kernels themselves to the
same two functions.
"""

import numpy as np
import pytest
import torch

from terran_tpu_torch.ops.fused_peaks import (
    FACTOR, TILE_SRC_COLS, TILE_SRC_ROWS, decode_tile_keys, find_peaks_fused,
    find_peaks_fused_plain, merge_candidates, num_tiles, tap_reach,
)
from terran_tpu_torch.ops.upsample import upsample_bicubic
from torch_port_fixtures import single_torch_thread  # noqa: F401

BIG = 2 ** 31 - 1
M32 = np.uint64(0xFFFFFFFF)


def np_key(scores, lin):
    """The kernel's make_key: order-preserving score bits in the high
    word, (INT_MAX - lin) << 1 in the low word, bit 0 = the score was
    -0.0 (keyed as +0.0)."""
    s = np.asarray(scores, np.float32)
    neg_zero = ((s == 0) & np.signbit(s)).astype(np.uint64)
    bits = np.where(s == 0, np.float32(0), s).view(np.uint32)
    bits = bits.astype(np.uint64)
    hi = np.where(bits >= 2 ** 31, ~bits & M32, bits | np.uint64(2 ** 31))
    lo = ((BIG - np.asarray(lin, np.int64)).astype(np.uint64)
          << np.uint64(1)) | neg_zero
    return (hi << np.uint64(32)) | lo


def np_decode(keys):
    """The kernel's key_score and key_lin."""
    keys = np.asarray(keys, np.uint64)
    hi = keys >> np.uint64(32)
    lo = keys & M32
    bits = np.where(hi >= 2 ** 31, hi - np.uint64(2 ** 31), ~hi & M32)
    bits = np.where(lo & np.uint64(1), np.uint64(2 ** 31), bits)
    scores = bits.astype(np.uint32).view(np.float32)
    return scores, (BIG - (lo >> np.uint64(1)).astype(np.int64))


def torch_order(scores, lin):
    """(score desc, index asc) as ``merge_candidates`` and ``find_peaks``
    sort: stable by index, then stable by descending score."""
    s = torch.from_numpy(np.asarray(scores, np.float32))
    l = torch.from_numpy(np.asarray(lin, np.int64))
    by_lin = torch.sort(l, stable=True).indices
    by_score = torch.sort(s[by_lin], descending=True, stable=True).indices
    return by_lin[by_score].numpy()


def peak_mask(up, threshold):
    """find_peaks' rule on an (H, W) field: `>=` the 4 neighbours and the
    threshold, 1-px interior."""
    mask = np.zeros(up.shape, bool)
    c = up[1:-1, 1:-1]
    mask[1:-1, 1:-1] = ((c >= up[:-2, 1:-1]) & (c >= up[2:, 1:-1])
                        & (c >= up[1:-1, :-2]) & (c >= up[1:-1, 2:])
                        & (c >= threshold))
    return mask


def emulate_scan(up, threshold, k):
    """Scan kernel on one (H, W) upsampled plane: per tile, the exact count
    and the top min(count, K) keys, written at their rank."""
    tile_h, tile_w = TILE_SRC_ROWS * FACTOR, TILE_SRC_COLS * FACTOR
    mask = peak_mask(up, threshold)
    lists, counts = [], []
    for y0 in range(0, up.shape[0], tile_h):
        for x0 in range(0, up.shape[1], tile_w):
            ys, xs = np.nonzero(mask[y0:y0 + tile_h, x0:x0 + tile_w])
            ys, xs = ys + y0, xs + x0
            keys = np_key(up[ys, xs], ys * up.shape[1] + xs)
            rank = (keys[None, :] > keys[:, None]).sum(axis=1)
            out = np.zeros(min(len(keys), k), np.uint64)
            out[rank[rank < k]] = keys[rank < k]
            lists.append(out)
            counts.append(len(keys))
    return lists, counts


def emulate_merge(lists, counts, k, up_w):
    """Merge kernel on one plane's tile lists."""
    kept = np.zeros(k, np.uint64)
    for t, own in enumerate(lists):
        for i, key in enumerate(own):
            rank = i
            for u, other in enumerate(lists):
                if u != t:
                    # Keys larger than `key` in the descending list.
                    rank += len(other) - np.searchsorted(
                        other[::-1], key, side="right")
            if rank < k:
                kept[rank] = key
    n_kept = min(sum(counts), k)
    scores, lin = np_decode(kept[:n_kept])
    finite = np.isfinite(scores)
    order = (~finite).astype(np.int64) << 32 | lin
    pos = (order[None, :] < order[:, None]).sum(axis=1)
    coords = np.zeros((k, 2), np.int32)
    out_s = np.zeros(k, np.float32)
    valid = np.zeros(k, bool)
    coords[pos, 0] = np.where(finite, lin // up_w, 0)
    coords[pos, 1] = np.where(finite, lin % up_w, 0)
    out_s[pos] = np.where(finite, scores, np.float32(0))
    valid[pos] = finite
    return coords, out_s, valid, sum(counts) > k


def emulate(heat, threshold, k):
    """Both kernels on (h, w, P) source heatmaps, planes leading, plus the
    scan's per-tile output in the (M, T, K) layout."""
    h, w, parts = heat.shape
    up = upsample_bicubic(torch.from_numpy(heat)[None], FACTOR)[0].numpy()
    outs, tile_keys, tile_counts = [], [], []
    for p in range(parts):
        lists, counts = emulate_scan(up[..., p], threshold, k)
        assert len(lists) == num_tiles(h, w)
        outs.append(emulate_merge(lists, counts, k, w * FACTOR))
        padded = np.zeros((len(lists), k), np.uint64)
        for t, keys in enumerate(lists):
            padded[t, :len(keys)] = keys
        tile_keys.append(padded)
        tile_counts.append(counts)
    merged = tuple(np.stack(parts_) for parts_ in zip(*outs))
    return merged, np.stack(tile_keys), np.array(tile_counts, np.int32)


def assert_bitwise(got, expected):
    for name, g, e in zip(("coords", "scores", "valid", "overflow"), got,
                          expected):
        g, e = np.asarray(g), np.asarray(e)
        assert g.shape == e.shape and g.dtype == e.dtype, name
        if g.dtype == np.float32:
            g, e = g.view(np.uint32), e.view(np.uint32)
        np.testing.assert_array_equal(g, e, err_msg=name)


def _plateau_across_tiles():
    # Equal bumps centred in different tiles: exact ties across tiles.
    heat = np.zeros((12, 20, 1), np.float32)
    for cy, cx in [(2, 3), (2, 11), (6, 3), (6, 11), (10, 17)]:
        heat[cy, cx, 0] = 0.9
    return heat


CASES = {
    # name: (heat builder, threshold, K)
    "cross-tile ties": (lambda rng: _plateau_across_tiles(), 0.1, 3),
    "count below K": (
        lambda rng: rng.normal(scale=0.2, size=(9, 13, 2)), 0.1, 64),
    # Tiles hold up to 8 peaks: their lists are cut at K too.
    "count above K": (
        lambda rng: rng.normal(scale=0.2, size=(10, 19, 2)), 0.1, 4),
    "K=1": (lambda rng: rng.normal(scale=0.2, size=(9, 17, 2)), 0.1, 1),
    "K=37": (lambda rng: rng.normal(scale=0.2, size=(11, 18, 2)), 0.1, 37),
    "whole-plateau tile": (
        lambda rng: np.full((6, 10, 1), 0.5, np.float32), 0.1, 37),
    "negative threshold, -0.0 values": (
        lambda rng: -np.abs(rng.normal(scale=0.2, size=(5, 9, 1))) * (
            rng.uniform(size=(5, 9, 1)) < 0.5), -0.5, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernels_match_plain_versions(case, rng):
    build, threshold, k = CASES[case]
    heat = np.ascontiguousarray(build(rng), np.float32)
    merged, tile_keys, tile_counts = emulate(heat, threshold, k)

    plain = find_peaks_fused_plain(torch.from_numpy(heat), threshold, k)
    assert_bitwise(merged, [t.numpy() for t in plain])

    scores, lin = decode_tile_keys(
        torch.from_numpy(tile_keys.view(np.int64)),
        torch.from_numpy(tile_counts))
    from_merge = merge_candidates(scores, lin, torch.from_numpy(tile_counts),
                                  k, heat.shape[1] * FACTOR)
    assert_bitwise(merged, [t.numpy() for t in from_merge])


def test_whole_plateau_tile_keeps_first_indices():
    """Every interior pixel of a constant field is a peak: ties all the
    way, so the kept set is the first K row-major interior pixels."""
    heat = np.full((6, 10, 1), 0.5, np.float32)
    lists, counts = emulate_scan(
        upsample_bicubic(torch.from_numpy(heat)[None], FACTOR)[0, ..., 0]
        .numpy(), 0.1, 37)
    assert counts[0] == TILE_SRC_ROWS * FACTOR * TILE_SRC_COLS * FACTOR - (
        TILE_SRC_ROWS * FACTOR + TILE_SRC_COLS * FACTOR - 1)
    assert sum(counts) == (6 * 8 - 2) * (10 * 8 - 2)
    (coords, scores, valid, overflow), _, _ = emulate(heat, 0.1, 37)
    assert valid.all() and overflow.all() and (scores == 0.5).all()
    np.testing.assert_array_equal(coords[0, :, 0], 1)
    np.testing.assert_array_equal(coords[0, :, 1], np.arange(1, 38))


def test_key_orders_as_the_plain_sort(rng):
    """Seeded ties, +-0.0, negatives, +-inf and NaN: descending keys give
    the order of the plain version's stable sorts, and decode back to the
    same bits."""
    pool = np.array([0.0, -0.0, 0.5, -0.5, 1e-30, -1e-30, np.inf, -np.inf,
                     np.nan, 0.25, 3.0e38, -3.0e38], np.float32)
    scores = rng.choice(pool, size=400)
    scores[:50] = rng.normal(size=50).astype(np.float32)
    lin = rng.permutation(2 ** 20)[:400]
    keys = np_key(scores, lin)
    np.testing.assert_array_equal(np.argsort(keys)[::-1],
                                  torch_order(scores, lin))

    got_s, got_l = np_decode(keys)
    np.testing.assert_array_equal(got_l, lin)
    np.testing.assert_array_equal(got_s.view(np.uint32),
                                  scores.view(np.uint32))
    # The port's own decoder reads the same keys the same way.
    t_keys = torch.from_numpy(keys.view(np.int64).reshape(1, 1, -1))
    t_s, t_l = decode_tile_keys(t_keys, torch.tensor([[400]],
                                                     dtype=torch.int32))
    np.testing.assert_array_equal(t_s.numpy().ravel().view(np.uint32),
                                  scores.view(np.uint32))
    np.testing.assert_array_equal(t_l.numpy().ravel(), lin)


def test_decode_masks_unused_slots():
    keys = np_key(np.array([0.7, 0.3, 0.1], np.float32), np.array([4, 9, 2]))
    t_s, t_l = decode_tile_keys(
        torch.from_numpy(keys.view(np.int64).reshape(1, 1, 3)),
        torch.tensor([[2]], dtype=torch.int32))
    np.testing.assert_array_equal(t_s.numpy().ravel(),
                                  np.float32([0.7, 0.3, -np.inf]))
    np.testing.assert_array_equal(t_l.numpy().ravel(), [4, 9, BIG])


@pytest.mark.parametrize("k", [0, 1, 37])
def test_non_contiguous_channel_view(k, rng):
    """The pose path passes heat[..., :18] of a 19-channel map, a strided
    view; the result equals that of the contiguous copy."""
    heat = torch.from_numpy(
        rng.normal(scale=0.2, size=(2, 7, 9, 19)).astype(np.float32))
    view = heat[..., :18]
    assert not view.is_contiguous()
    got = find_peaks_fused(view, 0.1, k)
    expected = find_peaks_fused(view.contiguous(), 0.1, k)
    for g, e in zip(got, expected):
        assert g.shape == e.shape and torch.equal(g, e)
    assert got[0].shape == (2, 18, k, 2)


def test_tiles_cover_the_field():
    assert num_tiles(23, 40) == 6 * 5
    assert num_tiles(46, 80) == 12 * 10
    assert num_tiles(1, 1) == 1


@pytest.mark.parametrize("scale", [1e-30, 0.2, 3.0e30])
def test_tap_reach_bounds_every_tile(scale, rng):
    """The scan kernel skips a tile when tap_reach() * max |patch| is below
    the threshold: every upsampled value of the tile and its 1-px halo
    must be bounded so, on fields of either sign and any magnitude."""
    h, w = 13, 19
    heat = (rng.normal(size=(h, w, 3)) * scale).astype(np.float32)
    heat[..., 2] = np.where(rng.uniform(size=(h, w)) < 0.8, 0, heat[..., 2])
    up = upsample_bicubic(torch.from_numpy(heat)[None], FACTOR)[0].numpy()
    reach = np.float32(tap_reach())
    tile_h, tile_w = TILE_SRC_ROWS * FACTOR, TILE_SRC_COLS * FACTOR
    for sy0 in range(0, h, TILE_SRC_ROWS):
        for sx0 in range(0, w, TILE_SRC_COLS):
            rows = np.clip(np.arange(sy0 - 2, sy0 + TILE_SRC_ROWS + 2), 0,
                           h - 1)
            cols = np.clip(np.arange(sx0 - 2, sx0 + TILE_SRC_COLS + 2), 0,
                           w - 1)
            patch = np.abs(heat[np.ix_(rows, cols)]).max(axis=(0, 1))
            y0, x0 = sy0 * FACTOR, sx0 * FACTOR
            vals = up[max(y0 - 1, 0):y0 + tile_h + 1,
                      max(x0 - 1, 0):x0 + tile_w + 1]
            assert (np.abs(vals).max(axis=(0, 1)) <= patch * reach).all()
    # max_r (sum_i |w_ri|) ** 2 for the A = -0.75 taps, plus the margin.
    assert 1.87 < tap_reach() < 1.88
