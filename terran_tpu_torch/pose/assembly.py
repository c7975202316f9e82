"""Host-side OpenPose greedy limb matching and human assembly.

A copy of ``terran_tpu/pose/assembly.py``: the data-dependent tail of the
reference decode — greedy bipartite matching per limb
(openpose/wrapper.py:335-366) and incremental human merging
(wrapper.py:368-478) — on the fixed-size masked arrays produced by the
on-device decode (``terran_tpu_torch.ops.pose_decode``). These stages are
O(people^2) on a handful of rows, so they run on the host: in C++
(``terran_tpu_torch.native``) where the library builds, else in the
Python version here, which gives the same humans. Both take a pose
family's :class:`~terran_tpu_torch.ops.pose_decode.Skeleton` (COCO-18 by
default, or BODY_25): its parts, its limbs in order and which limbs may
start a human; the algorithm and its thresholds are the same for both.
"""

import numpy as np

from terran_tpu_torch.ops.pose_decode import COCO_18


def greedy_connections(reg_scores, accept, count_src, count_dst):
    """Greedy highest-score matching for one limb.

    Mirrors the reference's candidate ordering (row-major nonzero, then
    stable by descending score) and its greedy loop semantics, including
    stopping once min(count_src, count_dst) connections are made
    (wrapper.py:332-359).

    Returns an (n, 3) array of (src_slot, dst_slot, score).
    """
    cand = np.argwhere(accept)
    if cand.size == 0:
        return np.zeros((0, 3))
    scores = reg_scores[cand[:, 0], cand[:, 1]]

    connections = []
    seen = set()
    for order_idx in np.argsort(-scores):
        i, j = cand[order_idx]
        if i not in seen and j not in seen:
            connections.append((i, j, reg_scores[i, j]))
            if len(connections) >= min(count_src, count_dst):
                break
            seen.add(i)
            seen.add(j)
    return np.array(connections, dtype=np.float64).reshape(-1, 3)


def assemble_humans(peak_coords, peak_scores, peak_valid, reg_scores, accept,
                    human_threshold=0.4, use_native=None, skeleton=COCO_18):
    """Build humans from per-limb connections for one image.

    Parameters are the per-image device outputs: peak_coords (P, K, 2),
    peak_scores (P, K), peak_valid (P, K), reg_scores (L, K, K),
    accept (L, K, K).

    Returns (peaks_by_id (N_peaks, 3) rows of (y, x, score), humans
    (N_humans, P + 2)) following the reference layout: first P entries
    (``skeleton.parts``, 18 for COCO) are global peak ids (or -1), then
    score sum, then keypoint count (wrapper.py:368-380).

    Runs the C++ version (``terran_tpu_torch.native``) when it is
    available; ``use_native=False`` forces this Python version.
    """
    counts = peak_valid.sum(axis=1).astype(int)  # (P,)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])

    rows = [
        np.column_stack([
            peak_coords[p, : counts[p]].astype(np.float64),
            peak_scores[p, : counts[p]].astype(np.float64),
        ])
        for p in range(skeleton.parts)
    ]
    peaks_by_id = (
        np.concatenate(rows, axis=0) if any(len(r) for r in rows)
        else np.zeros((0, 3))
    )

    if use_native is not False:
        from terran_tpu_torch import native

        if native.native_available():
            humans = native.assemble_humans_native(
                peak_scores, counts, offsets, reg_scores, accept,
                skeleton.limbseq, skeleton.starts,
                human_threshold=human_threshold,
            )
            return peaks_by_id, humans

    row = skeleton.parts + 2
    humans = np.ones((0, row)) * -1

    for limb_id in range(skeleton.limbs):
        kpid_src, kpid_dst = skeleton.limbseq[limb_id]
        if counts[kpid_src] == 0 or counts[kpid_dst] == 0:
            continue

        conns = greedy_connections(
            reg_scores[limb_id], accept[limb_id],
            counts[kpid_src], counts[kpid_dst],
        )

        for src_slot, dst_slot, score in conns:
            peak_src = offsets[kpid_src] + int(src_slot)
            peak_dst = offsets[kpid_dst] + int(dst_slot)

            matched_with = [
                idx for idx, human in enumerate(humans)
                if human[kpid_src] == peak_src or human[kpid_dst] == peak_dst
            ]

            if len(matched_with) == 1:
                human = humans[matched_with[0]]
                if human[kpid_dst] != peak_dst:
                    human[kpid_dst] = peak_dst
                    human[-1] += 1
                    human[-2] += peaks_by_id[peak_dst, 2] + score
            elif len(matched_with) == 2:
                human_1 = humans[matched_with[0]]
                human_2 = humans[matched_with[1]]
                membership = (
                    (human_1 >= 0).astype(int) + (human_2 >= 0).astype(int)
                )[:-2]
                if not np.flatnonzero(membership == 2).size:
                    # Disjoint part sets: merge the two partial humans
                    # (the +1 compensates the -1 absence marker).
                    human_1[:-2] += human_2[:-2] + 1
                    human_1[-2:] += human_2[-2:]
                    human_1[-2] += score
                    humans = np.delete(humans, matched_with[1], 0)
                else:
                    # Overlap conflict: tiebreak into the first human.
                    human_1[kpid_dst] = peak_dst
                    human_1[-1] += 1
                    human_1[-2] += peaks_by_id[peak_dst, 2] + score
            elif not matched_with and skeleton.starts[limb_id]:
                human = np.ones(row) * -1
                human[kpid_src] = peak_src
                human[kpid_dst] = peak_dst
                human[-1] = 2
                human[-2] = (
                    peaks_by_id[peak_src, 2] + peaks_by_id[peak_dst, 2] + score
                )
                humans = np.vstack([humans, human])

    # Drop weak detections (wrapper.py:470-478).
    keep = [
        idx for idx, human in enumerate(humans)
        if human[-1] >= 4 and human[-2] / human[-1] >= human_threshold
    ]
    return peaks_by_id, humans[keep]


def get_keypoints(peaks_by_id, humans, scale=1.0):
    """Final keypoint dicts, rescaled to the original image
    (wrapper.py:37-90): per human a (P, 3) int32 array of (x, y, present),
    P the humans' parts (18 for COCO, 25 for BODY_25), plus the average
    keypoint score."""
    parts = humans.shape[1] - 2
    detections = []
    for human in humans:
        keypoints = np.zeros((parts, 3), dtype=np.int32)
        for j in range(parts):
            peak_id = int(human[j])
            if peak_id != -1:
                y, x = peaks_by_id[peak_id][:2]
                keypoints[j] = (
                    np.int32(x / scale), np.int32(y / scale), 1
                )
        detections.append({
            "keypoints": keypoints,
            "score": human[-2] / human[-1],
        })
    return detections
