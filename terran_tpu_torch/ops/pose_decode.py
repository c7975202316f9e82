"""On-device OpenPose decode: peak finding and PAF line-integral scoring.

The port of ``terran_tpu/ops/pose_decode.py``: the whole batch is decoded
on the device into fixed-size masked tensors (reference per-image loop:
openpose/wrapper.py:226-366), and only the greedy matching and human
assembly run on the host (``terran_tpu_torch.pose.assembly``).

- **Peaks** (wrapper.py:235-262): 4-neighbour local maxima over each part
  heatmap, `>=` comparisons with a 1px interior margin and score
  threshold, extracted into ``max_peaks`` slots per part in row-major order
  (the reference's ``torch.nonzero`` order) with a validity mask.
- **Limb scores** (wrapper.py:274-333): for all limbs at once, the
  10-midpoint line integral of the PAF field between every (src, dst) peak
  pair, the length-regularised score, and the two acceptance criteria.

The parts and limbs are a pose family's :class:`Skeleton`: the COCO
model's 18 parts and 19 limbs (:data:`COCO_18`, the default) or BODY_25's
25 and 26 (:data:`BODY_25`).

Every function takes optional leading batch dimensions. Divisions by a
constant divide by a tensor on the same device: PyTorch's CUDA division by
a Python scalar multiplies by its reciprocal, which can differ by an ulp
and move a truncated sample point. Such scalars are filled on the device
and index tables come from ``runtime.device_constant``, so that nothing
here copies from host memory and waits for the card.
"""

from typing import NamedTuple

import numpy as np
import torch

from terran_tpu_torch.ops.upsample import sample_bicubic, upsample_bicubic
from terran_tpu_torch.runtime import device_constant

# Limb topology tables for the CMU 2017 body model — public OpenPose
# constants (reference copies at openpose/wrapper.py:12-23). ``MAP_IDX``
# indexes PAF channel pairs (x, y) after the -19 offset; ``LIMBSEQ`` is
# 1-based keypoint ids per limb. They keep the JAX package's names; the
# port reads them through ``COCO_18`` below.
MAP_IDX = np.array([
    [31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44],
    [19, 20], [21, 22], [23, 24], [25, 26], [27, 28], [29, 30],
    [47, 48], [49, 50], [53, 54], [51, 52], [55, 56], [37, 38],
    [45, 46],
]) - 19

LIMBSEQ = np.array([
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9],
    [9, 10], [10, 11], [2, 12], [12, 13], [13, 14], [2, 1],
    [1, 15], [15, 17], [1, 16], [16, 18], [3, 17], [6, 18],
]) - 1

NUM_PARTS = 18
NUM_LIMBS = 19


class Skeleton(NamedTuple):
    """A pose family's parts and limbs.

    ``parts``: the part heatmaps the peaks are found on (the network's
    first channels). ``limbseq``: (L, 2) 0-based (source, destination)
    part of each limb, in the order limbs are scored and assembled.
    ``map_idx``: (L, 2) the (x, y) channels of each limb in the PAF
    field. ``starts``: (L,) whether a limb matching no human may start
    one; the redundant limbs (an ear to a shoulder) may only join
    humans."""

    parts: int
    limbseq: np.ndarray
    map_idx: np.ndarray
    starts: np.ndarray

    @property
    def limbs(self):
        return len(self.limbseq)


# The CMU 2017 COCO body model: 18 parts, 19 limbs, the last two redundant.
COCO_18 = Skeleton(NUM_PARTS, LIMBSEQ, MAP_IDX,
                   np.arange(NUM_LIMBS) < NUM_LIMBS - 2)

# OpenPose's BODY_25 (poseParameters.cpp): POSE_BODY_25_PAIRS and
# POSE_BODY_25_MAP_INDEX (counted from the first PAF channel, 26 of the
# network's joined output). Its redundant limbs are the ear-shoulder
# pairs 18 and 19, which OpenPose's connector also sets apart.
BODY_25 = Skeleton(
    25,
    np.array([
        [1, 8], [1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [8, 9],
        [9, 10], [10, 11], [8, 12], [12, 13], [13, 14], [1, 0], [0, 15],
        [15, 17], [0, 16], [16, 18], [2, 17], [5, 18], [14, 19],
        [19, 20], [14, 21], [11, 22], [22, 23], [11, 24],
    ]),
    np.array([
        [0, 1], [14, 15], [22, 23], [16, 17], [18, 19], [24, 25],
        [26, 27], [6, 7], [2, 3], [4, 5], [8, 9], [10, 11], [12, 13],
        [30, 31], [32, 33], [36, 37], [34, 35], [38, 39], [20, 21],
        [28, 29], [40, 41], [42, 43], [44, 45], [46, 47], [48, 49],
        [50, 51],
    ]),
    ~np.isin(np.arange(26), (18, 19)),
)

# limb_scores reads each (x, y) PAF pair at channel c and c + 1.
assert all((s.map_idx[:, 1] == s.map_idx[:, 0] + 1).all()
           for s in (COCO_18, BODY_25))

NUM_MIDPOINTS = 10


def _divide(x, value):
    """``x / value`` as a true float32 division on ``x``'s device."""
    return x / _scalar(value, x)


def _scalar(value, like):
    """``value`` as a 0-dim tensor of ``like``'s dtype, filled on its
    device: no copy from host memory, which would wait for the card."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def top_k_first(values, k):
    """Top ``k`` along the last axis, ties toward the earlier index (the
    order of ``jax.lax.top_k``; ``torch.topk`` promises none)."""
    order = torch.sort(values, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return values.gather(-1, order), order


def find_peaks(heatmaps, threshold, max_peaks):
    """Fixed-K local-maximum extraction per part.

    heatmaps: (..., H, W, P) float. Returns (coords (..., P, K, 2) int32 as
    (y, x), scores (..., P, K), valid (..., P, K) bool, overflow (..., P)
    bool), peaks ordered row-major per part.

    When a part has more than ``max_peaks`` local maxima, the K
    highest-scoring ones are kept (score ties broken toward earlier
    row-major positions) and ``overflow`` is set for that part; the kept
    set is then re-ordered row-major, the order of the reference's
    ``torch.nonzero`` extraction (wrapper.py:246-253).
    """
    h, w, p = heatmaps.shape[-3:]
    hm = heatmaps.movedim(-1, -3)  # (..., P, H, W)

    interior = hm[..., 1:-1, 1:-1]
    peaks = torch.zeros(hm.shape, dtype=torch.bool, device=hm.device)
    peaks[..., 1:-1, 1:-1] = (
        (interior >= hm[..., :-2, 1:-1])
        & (interior >= hm[..., 1:-1, :-2])
        & (interior >= hm[..., 2:, 1:-1])
        & (interior >= hm[..., 1:-1, 2:])
        & (interior >= threshold)
    )

    flat = peaks.flatten(-2)
    flat_hm = hm.flatten(-2)
    overflow = flat.sum(dim=-1) > max_peaks

    sel_score = torch.where(flat, flat_hm, float("-inf"))
    top_scores, idx = top_k_first(sel_score, max_peaks)  # (..., P, K)
    valid = torch.isfinite(top_scores)

    # Re-order the kept set row-major (invalid slots sort last).
    position = torch.where(valid, idx, h * w)
    row_major = torch.sort(position, dim=-1, stable=True).indices
    idx = idx.gather(-1, row_major)
    valid = valid.gather(-1, row_major)
    scores = flat_hm.gather(-1, idx)

    coords = torch.stack([idx // w, idx % w], dim=-1).to(torch.int32)
    return coords, torch.where(valid, scores, 0.0), valid, overflow


def _limb_geometry(coords, valid, ups_h, ups_w, skeleton):
    """Shared pair geometry for limb scoring over ``skeleton``'s limbs.

    coords: (..., P, K, 2) int peak positions in the UPSAMPLED grid; valid:
    (..., P, K). Returns (seg_y, seg_x (..., L, K, K, M) int64 clipped to
    the upsampled bounds, dirs (..., L, K, K, 2), norms, safe_norms,
    pair_valid).
    """
    src_parts, dst_parts = (
        device_constant(tuple(skeleton.limbseq[:, i].tolist()), torch.int64,
                        coords.device)
        for i in (0, 1)
    )

    loc_src = coords.index_select(-3, src_parts).to(torch.float32)
    loc_dst = coords.index_select(-3, dst_parts).to(torch.float32)
    val_src = valid.index_select(-2, src_parts)  # (..., L, K)
    val_dst = valid.index_select(-2, dst_parts)

    # Directions (..., L, K_src, K_dst, 2) in (dy, dx), like the
    # reference's (y, x) peak coordinates (wrapper.py:296-301).
    diff = loc_dst[..., None, :, :] - loc_src[..., :, None, :]
    norms = torch.sqrt((diff * diff).sum(dim=-1))
    safe_norms = torch.clamp_min(norms, 1e-6)
    dirs = diff / safe_norms[..., None]

    # Segment sample points: linspace of NUM_MIDPOINTS between src and dst,
    # truncated to int (torch .type(torch.long), wrapper.py:304-306; coords
    # are non-negative so truncation == floor), with torch.linspace's
    # float32 arithmetic start + i * (stop - start) / (steps - 1).
    steps = torch.arange(NUM_MIDPOINTS, dtype=torch.float32,
                         device=coords.device)
    step_size = _divide(diff, float(NUM_MIDPOINTS - 1))
    seg = (
        loc_src[..., :, None, None, :]
        + step_size[..., None, :] * steps[:, None]
    )  # (..., L, K, K, M, 2)
    seg = seg.to(torch.int32).to(torch.int64)
    seg_y = seg[..., 0].clamp(0, ups_h - 1)
    seg_x = seg[..., 1].clamp(0, ups_w - 1)

    pair_valid = val_src[..., :, None] & val_dst[..., None, :] & (norms > 0)
    return seg_y, seg_x, dirs, norms, safe_norms, pair_valid


def _score_pairs(px, py, dirs, safe_norms, pair_valid, ups_h,
                 thresh_midpoint):
    """Midpoint scores -> (reg, accept), given sampled PAF values."""
    # midpoint score = paf_x * dx + paf_y * dy (direction flip,
    # wrapper.py:308-315).
    mid = px * dirs[..., 1][..., None] + py * dirs[..., 0][..., None]

    # Length-regularised score (wrapper.py:320-323); the reference's
    # pafs.shape[1] is the upsampled height H.
    length_term = _scalar(0.5 * ups_h, safe_norms) / safe_norms - 1.0
    reg = _divide(mid.sum(dim=-1), float(NUM_MIDPOINTS)) + torch.clamp_max(
        length_term, 0.0
    )

    crit1 = (mid > thresh_midpoint).sum(dim=-1) > 0.8 * NUM_MIDPOINTS
    crit2 = reg > 0
    accept = crit1 & crit2 & pair_valid
    return reg, accept


def limb_scores(pafs, coords, valid, thresh_midpoint, skeleton=COCO_18):
    """Line-integral limb scoring for all of ``skeleton``'s limbs and pairs
    at once.

    pafs: (..., H, W, C) — the UPSAMPLED field, C PAF channels (38 for
    COCO-18, 52 for BODY_25); coords: (..., P, K, 2)
    int (y, x); valid: (..., P, K). Returns (reg_scores (..., L, K, K),
    accept (..., L, K, K) bool), where ``accept`` combines the reference's
    two criteria and slot validity. Samples are read by gathering from the
    channel-minor field (the gather form of ``terran_tpu``'s
    ``limb_scores``).
    """
    h, w, c = pafs.shape[-3:]
    seg_y, seg_x, dirs, norms, safe_norms, pair_valid = _limb_geometry(
        coords, valid, h, w, skeleton
    )

    channel = device_constant(tuple(skeleton.map_idx[:, 0].tolist()),
                              torch.int64, pafs.device)
    channel = channel.view(skeleton.limbs, 1, 1, 1)
    index = (seg_y * w + seg_x) * c + channel  # (..., L, K, K, M)
    flat = pafs.reshape(-1, h * w * c)
    index = index.reshape(flat.shape[0], -1)
    px = flat.gather(1, index).reshape(seg_y.shape)
    py = flat.gather(1, index + 1).reshape(seg_y.shape)

    return _score_pairs(
        px, py, dirs, safe_norms, pair_valid, h, thresh_midpoint
    )


def limb_scores_sampled(pafs_small, factor, coords, valid, thresh_midpoint,
                        skeleton=COCO_18):
    """:func:`limb_scores` on the x``factor`` bicubic upsample of
    ``pafs_small`` without building it: each segment point samples the
    field through ``ops.upsample.sample_bicubic`` (the port of
    ``terran_tpu/ops/pose_decode.py::limb_scores_sampled``). Bit for bit
    ``limb_scores(upsample_bicubic(pafs_small, factor), ...)``; the
    pipeline and ``make_pose_decode`` keep that materialised form
    (:func:`limb_table`).

    pafs_small: (..., h, w, C), the network-resolution field; coords,
    valid as :func:`limb_scores`, in the upsampled grid.
    """
    h, w = pafs_small.shape[-3:-1]
    ups_h, ups_w = h * factor, w * factor
    seg_y, seg_x, dirs, norms, safe_norms, pair_valid = _limb_geometry(
        coords, valid, ups_h, ups_w, skeleton
    )
    planes = pafs_small.movedim(-1, -3)  # (..., C, h, w)

    def sample(column):
        channel = device_constant(tuple(skeleton.map_idx[:, column].tolist()),
                                  torch.int64, pafs_small.device)
        maps = planes.index_select(-3, channel).reshape(-1, h, w)
        points = seg_y.shape[-3:]
        return sample_bicubic(
            maps, factor, seg_y.reshape((-1,) + points),
            seg_x.reshape((-1,) + points),
        ).reshape(seg_y.shape)

    return _score_pairs(
        sample(0), sample(1), dirs, safe_norms, pair_valid, ups_h,
        thresh_midpoint,
    )


def limb_table(pafs_small, coords, valid, thresh_midpoint, factor=8,
               skeleton=COCO_18):
    """The packed limb table (..., L, K, K, 2) = (reg_score, accept as
    float32) of :func:`limb_scores` on the x``factor`` bicubic upsample of
    ``pafs_small`` (..., h, w, C), the network-resolution field; coords,
    valid as :func:`limb_scores`, in the upsampled grid; L is
    ``skeleton``'s limbs."""
    reg, accept = limb_scores(upsample_bicubic(pafs_small, factor), coords,
                              valid, thresh_midpoint, skeleton)
    return torch.stack([reg, accept.to(torch.float32)], dim=-1)


def normalize_images(images, scale=255.0):
    """uint8 (N, H, W, 3) -> float32 ``x / scale - 0.5``: 255 for the COCO
    model (wrapper.py:116-122), 256 for BODY_25 (OpenPose's
    ``uCharCvMatToFloatPtr``)."""
    return _divide(images.to(torch.float32), scale) - 0.5


def forward_and_find_peaks(model, images, keypoint_threshold, max_peaks,
                           use_fused, factor=8, mesh=None, skeleton=COCO_18):
    """Normalise + pose forward + fixed-K peak finding on ``skeleton``'s
    parts. ``images`` are uint8 (N, H, W, 3) at the network input
    resolution, on the model's device; the model's ``input_scale``
    normalises them. Returns (paf x1 float32 NHWC, coords, scores, valid,
    overflow).

    ``mesh`` is the JAX function's keyword, whose Pallas kernel needs
    ``shard_map`` to run per shard. Under ``torch.distributed`` each rank
    calls this on its own rows, so the fused kernels already run per rank;
    with a mesh, ``images`` must lie on its device."""
    if mesh is not None and images.device != mesh.device:
        raise ValueError(f"images on {images.device}, not on the mesh's "
                         f"{mesh.device}")
    x = normalize_images(images, model.input_scale)
    paf, heat = model(x.to(model.compute_dtype))
    paf = paf.to(torch.float32)
    heat = heat.to(torch.float32)[..., :skeleton.parts]

    if use_fused:
        from terran_tpu_torch.ops.fused_peaks import find_peaks_fused

        coords, scores, valid, overflow = find_peaks_fused(
            heat, keypoint_threshold, max_peaks, factor=factor,
        )
    else:
        from terran_tpu_torch.ops.upsample import upsample_bicubic

        # The background channel is sliced off before the x8 FIR.
        coords, scores, valid, overflow = find_peaks(
            upsample_bicubic(heat, factor), keypoint_threshold, max_peaks
        )
    return paf, coords, scores, valid, overflow


def pack_peaks(coords, scores, valid, overflow):
    """Pack peak outputs as (..., P, K, 5) = (y, x, score, valid,
    part_overflow broadcast along K) — the layout
    :func:`unpack_pose_outputs` consumes."""
    return torch.cat(
        [
            coords.to(torch.float32),
            scores[..., None],
            valid[..., None].to(torch.float32),
            overflow[..., None, None].expand(
                coords.shape[:-1] + (1,)
            ).to(torch.float32),
        ],
        dim=-1,
    )


def make_pose_decode(model, *, keypoint_threshold=0.1, thresh_midpoint=0.05,
                     max_peaks=32, downsampling_ratio=8,
                     use_fused_peaks=None):
    """Build the batched decode for ``model``.

    Maps images (N, H, W, 3) uint8 RGB tensors on the model's device to two
    packed tensors — peaks (N, P, K, 5) = (y, x, score, valid,
    part_overflow) and limbs (N, L, K, K, 2) = (reg_score, accept) —
    splittable with :func:`unpack_pose_outputs`.

    ``use_fused_peaks`` (default: config ``fused_peaks``) selects the fused
    upsample + peak-scan; the PAF field is always materialised at x8.
    """
    from terran_tpu_torch.ops.fused_peaks import fused_peaks_enabled

    if use_fused_peaks is None:
        use_fused_peaks = fused_peaks_enabled()

    @torch.inference_mode()
    def decode(images):
        paf, coords, scores, valid, overflow = forward_and_find_peaks(
            model, images, keypoint_threshold, max_peaks, use_fused_peaks,
            factor=downsampling_ratio,
        )
        limbs = limb_table(paf, coords, valid, thresh_midpoint,
                           downsampling_ratio)
        peaks = pack_peaks(coords, scores, valid, overflow)
        return peaks, limbs

    return decode


def unpack_pose_outputs(peaks, limbs):
    """Split packed decode outputs (numpy) back into
    (coords int32, scores, valid bool, reg, accept bool, overflow bool).

    ``overflow`` has the peak arrays' leading dims up to the part axis
    ((..., P)) — True where a part's local maxima exceeded the fixed K."""
    coords = peaks[..., :2].astype(np.int32)
    scores = peaks[..., 2]
    valid = peaks[..., 3] > 0.5
    overflow = peaks[..., 0, 4] > 0.5
    reg = limbs[..., 0]
    accept = limbs[..., 1] > 0.5
    return coords, scores, valid, reg, accept, overflow
