"""The comparison that decides ``correct``: what the timed path produced
for a frame against the plain reference on the same frames and weights.

It reads the program's outputs only: each frame's K pre-selected
detections (boxes and landmarks at full resolution, scores, keep mask)
and its embeddings as ``process_stream`` yields them, the peak tables
the pipeline hands its pose assembly, and the tracks that
``MultiStreamPerception`` yields. Each number is the worst over the
frames compared. Where a choice of the program hangs on a near tie
(which anchors its top-K kept, which pixels it called peaks), the number
judges the choice by how far the reference's own values put it from the
right one, so that a near tie reads small and a wrong choice large:

- ``det_coord_gap``: each valid candidate's box and landmarks against
  the reference decode of the anchor that matches them best, less the
  half pixel of the program's rounding, relative to the anchor's width,
  the point's offset from the anchor's centre and the box's side;
- ``det_score_gap``: its score's logit against the reference's at that
  anchor, relative to the logit's size;
- ``det_rank_gap``: how far a chosen anchor's reference logit lies below
  the reference's K-th best (the top-K pre-selection), relative likewise;
- ``det_miss_gap``: how far an anchor the program left out lies above the
  lowest it chose (above the threshold, where it chose fewer than K), in
  the reference's logits, relative likewise: the pre-selection's recall;
- ``nms_iou_gap``: by how much each keep decision lies on the wrong side
  of the IoU threshold, its IoU taken in the reference's boxes of the
  chosen anchors against the earlier candidates the program kept (a kept
  candidate must overlap none of them by more, a suppressed one some);
- ``emb_cos_gap``: one minus the cosine of each embedded face against the
  reference embedding of a crop aligned to the same landmarks, 1 where
  the embedding mask disagrees with the keep mask;
- ``peak_score_gap``: each peak's score against the reference's x8
  heatmap at its pixel;
- ``peak_max_gap``: how far each peak lies below the highest of its four
  neighbours in the reference heatmap, or below the threshold;
- ``peak_miss_gap``: how far each reference local maximum lies above the
  program's peaks that cover it: those within ``COVER_PX`` pixels, else
  the lowest the program kept for the part (the threshold, where it kept
  fewer than ``max_peaks``), and at most by how far it stands above the
  ring ``RING_PX`` pixels around it (a lower bound of its prominence, so
  that a bump that rounding makes or unmakes on a slope reads small):
  the peak selection's recall;
- ``track_mismatches`` (camera cells): tracker outputs that differ from
  the reference SORT replayed over the same detections (exact).
"""

import numpy as np
import torch
import torch.nn.functional as F

from reference import pipeline as ref
from reference.models import FLOAT
from reference.sort import Sort

# A reference maximum is covered by a program peak this many pixels of
# the x8 heatmap away (half a cell of the network's output), so that a
# flat top's near tie in position reads as the values' difference.
COVER_PX = 4
# A reference maximum's standing: its height above the highest pixel of
# the square ring this many pixels around it (one cell of the network's
# output).
RING_PX = 8
DETECTION = ("det_coord_gap", "det_score_gap", "det_rank_gap",
             "det_miss_gap", "nms_iou_gap")
PEAKS = ("peak_score_gap", "peak_max_gap", "peak_miss_gap")


def _kth(values, k, floor):
    """The k-th largest of a 1-d tensor, or ``floor`` when fewer than k."""
    if values.numel() < k:
        return float(floor)
    return float(torch.topk(values, k).values[-1])


class Reference:
    """The reference's view of frames under one configuration and its
    families (``harness/families.py``: {role: Family}): float32, or with
    ``ops`` ({family: ops}) the control's lower precision. A role the
    configuration lacks gives nothing: no heatmaps without a pose family,
    no embeddings without a recognizer."""

    def __init__(self, weights, cfg, fams, ops=None):
        self.w, self.cfg, self.fams = weights, cfg, fams
        self.ops = ops or {}
        self.pose = "pose" in fams
        self.embeds = "recognizer" in fams

    def _call(self, role, fn, *args):
        fam = self.fams[role]
        return getattr(fam.binding, fn)(self.w[fam.name], *args,
                                        self.ops.get(fam.name, FLOAT))

    def detections(self, frames):
        return self._call("detector", "detect", frames,
                          self.cfg["det_short_side"])

    def anchors(self, height, width):
        return self.fams["detector"].binding.anchors(height, width)

    def heatmaps(self, frames):
        return self._call("pose", "heatmaps", frames,
                          self.cfg["pose_short_side"])

    def embed(self, frame, landmarks):
        return self._call("recognizer", "embed", frame, landmarks)

    def as_program(self, frames):
        """What the program's timed path would give for these frames, in
        its output format, computed by this reference: the control."""
        cfg = self.cfg
        n, h, w, _ = frames.shape
        _, _, det_scale = ref.resized_shape(h, w, cfg["det_short_side"])
        scores, boxes, lmks = self.detections(frames)
        k, faces = cfg["top_k"], cfg["max_faces"]
        masked = torch.where(scores >= cfg["threshold"], scores,
                             float("-inf"))
        top, order = torch.sort(masked, dim=1, descending=True, stable=True)
        top, order = top[:, :k], order[:, :k]
        heat = self.heatmaps(frames) if self.pose else None
        outs = []
        for i in range(n):
            b, l = boxes[i, order[i]], lmks[i, order[i]]
            keep = ref.greedy_nms(b, torch.isfinite(top[i]),
                                  cfg["nms_threshold"])
            coords = torch.round(torch.cat([b, l.reshape(-1, 10)], 1)
                                 / det_scale).to(torch.int32).cpu().numpy()
            out = {"boxes": coords[:, :4], "landmarks":
                   coords[:, 4:].reshape(-1, 5, 2), "scores":
                   top[i].cpu().numpy(), "mask": keep}
            if self.embeds:
                width = self.fams["recognizer"].binding.EMBED_DIM
                emb = np.zeros((faces, width), np.float32)
                slots = np.flatnonzero(keep[:faces])
                if slots.size:
                    emb[slots] = self.embed(
                        frames[i],
                        out["landmarks"][slots].astype(np.float32)
                    ).cpu().numpy()
                out["embeddings"], out["embeddings_mask"] = emb, keep[:faces]
            out["peaks"] = None if heat is None else self._peaks(heat[i])
            outs.append(out)
        return outs

    def _peaks(self, heat):
        """The top ``max_peaks`` local maxima of each part, as the
        program's peak tables: (coords (P, K, 2) y, x; scores; valid)."""
        k, parts = self.cfg["max_peaks"], heat.shape[0]
        peaks = ref.local_maxima(heat, self.cfg["keypoint_threshold"])
        w = heat.shape[-1]
        coords = np.zeros((parts, k, 2), np.int32)
        scores = np.zeros((parts, k), np.float32)
        valid = np.zeros((parts, k), bool)
        for p in range(parts):
            idx = torch.nonzero(peaks[p].flatten()).flatten()
            vals = heat[p].flatten()[idx]
            best = torch.sort(vals, descending=True, stable=True).indices[:k]
            idx = torch.sort(idx[best]).values
            m = idx.numel()
            coords[p, :m, 0] = (idx // w).cpu().numpy()
            coords[p, :m, 1] = (idx % w).cpu().numpy()
            scores[p, :m] = heat[p].flatten()[idx].cpu().numpy()
            valid[p, :m] = True
        return coords, scores, valid


def _logit(p):
    p = p.double().clamp(1e-7, 1 - 1e-7)
    return torch.log(p) - torch.log1p(-p)


def compare_frames(reference, frames, cands, numbers):
    """Fold the numbers of (N, H, W, 3) uint8 ``frames`` (a tensor on the
    reference's device) and their N candidate outputs into ``numbers``,
    a dict of running maxima. A candidate whose ``peaks`` is None (the
    program's tables were not recorded) adds no peak number; without a
    pose family no frame does, and without a recognizer none adds
    ``emb_cos_gap``."""
    cfg = reference.cfg
    n, h, w, _ = frames.shape
    dh, dw, det_scale = ref.resized_shape(h, w, cfg["det_short_side"])
    scores, boxes, lmks = reference.detections(frames)
    heat = reference.heatmaps(frames) if reference.pose else None
    anc = torch.from_numpy(reference.anchors(dh, dw)).to(frames.device)
    anchor_w = (anc[:, 2] - anc[:, 0] + 1.0) / det_scale
    centre = torch.stack([anc[:, 0] + 0.5 * (anc[:, 2] - anc[:, 0]),
                          anc[:, 1] + 0.5 * (anc[:, 3] - anc[:, 1])], -1)
    centre = centre.repeat(1, 7) / det_scale  # x, y of each of 7 points
    for i, cand in enumerate(cands):
        gaps = _detection_gaps(cand, scores[i], boxes[i], lmks[i], det_scale,
                               anchor_w, centre, cfg)
        if reference.embeds:
            gaps["emb_cos_gap"] = _embed_gap(reference, frames[i], cand,
                                             cfg["max_faces"])
        if heat is not None and cand.get("peaks") is not None:
            gaps.update(_peak_gaps(heat[i], cand["peaks"], cfg))
        for name, value in gaps.items():
            numbers[name] = max(numbers.get(name, 0.0), value)
    return numbers


def _match_anchors(c14, ref14, scale):
    """(V,) best gap and anchor of each candidate's 14 coordinates among
    the reference's (A, 14) decodes: the worst coordinate's excess over
    half a pixel, relative to ``scale``."""
    best, which = [], []
    for c in c14:
        gap = (((c - ref14).abs() - 0.5).clamp(min=0) / scale).amax(1)
        g, a = gap.min(0)
        best.append(g)
        which.append(a)
    return torch.stack(best), torch.stack(which)


def _detection_gaps(cand, scores, boxes, lmks, det_scale, anchor_w, centre,
                    cfg):
    dev = scores.device
    k, threshold = cfg["top_k"], cfg["threshold"]
    c_scores = torch.as_tensor(np.asarray(cand["scores"], np.float32),
                               device=dev)
    valid = torch.isfinite(c_scores)
    keep = torch.as_tensor(np.asarray(cand["mask"]), device=dev)
    lr_all = _logit(scores)
    above = scores >= threshold
    gaps = dict.fromkeys(DETECTION, 0.0)
    if bool((keep & ~valid).any()):
        gaps["nms_iou_gap"] = 1.0
    v = torch.nonzero(valid).flatten()
    if v.numel():
        ref14 = torch.cat([boxes, lmks.reshape(-1, 10)], 1) / det_scale
        # A point's error grows with its anchor's width and its offset
        # from the anchor's centre (both offsets in anchor widths), and a
        # corner's with the box's side (the exponential of an offset).
        side = torch.maximum(ref14[:, 2] - ref14[:, 0],
                             ref14[:, 3] - ref14[:, 1])
        scale = anchor_w[:, None] + (ref14 - centre).abs() + side.abs()[:, None]
        c14 = torch.as_tensor(np.concatenate(
            [np.asarray(cand["boxes"]),
             np.asarray(cand["landmarks"]).reshape(-1, 10)], 1),
            dtype=torch.float32, device=dev)[v]
        best, chosen = _match_anchors(c14, ref14, scale)
        gaps["det_coord_gap"] = float(best.max())
        # Scores compared as logits, relative to their size: near 1 a
        # score keeps few of its logit's digits.
        lr, lc = lr_all[chosen], _logit(c_scores[v])
        gaps["det_score_gap"] = float(((lc - lr).abs()
                                       / (1 + lr.abs())).max())
        lk = _logit(torch.tensor(_kth(scores[above], k, threshold),
                                 device=dev))
        gaps["det_rank_gap"] = float(((lk - lr).clamp(min=0)
                                      / (1 + lk.abs())).max())
        gaps["nms_iou_gap"] = max(gaps["nms_iou_gap"], _nms_gap(
            boxes[chosen], keep[v], cfg["nms_threshold"]))
        lowest = lr.min() if v.numel() >= k else None
    else:
        chosen, lowest = torch.zeros(0, dtype=torch.long, device=dev), None
    if lowest is None:
        lowest = _logit(torch.tensor(threshold, device=dev))
    missed = above.clone()
    missed[chosen] = False
    if bool(missed.any()):
        gaps["det_miss_gap"] = float(((lr_all[missed] - lowest).clamp(min=0)
                                      / (1 + lowest.abs())).max())
    return gaps


def _nms_gap(boxes, keep, threshold):
    """The widest margin by which a keep decision over (V, 4) boxes, in
    the program's order, lies on the wrong side of ``threshold``: each
    candidate against the earlier ones kept (greedy suppression's rule,
    judged decision by decision)."""
    idx = torch.arange(len(keep), device=keep.device)
    earlier_kept = keep[None, :] & (idx[None, :] < idx[:, None])
    overlap = torch.where(earlier_kept, ref.iou(boxes, boxes),
                          torch.zeros((), device=boxes.device)).amax(1)
    wrong = torch.where(keep, overlap - threshold, threshold - overlap)
    return float(wrong.clamp(min=0).max())


def _embed_gap(reference, frame, cand, faces):
    mask = np.asarray(cand["mask"])[:faces]
    emb_mask = np.asarray(cand["embeddings_mask"])[:faces]
    if not np.array_equal(mask, emb_mask):
        return 1.0
    slots = np.flatnonzero(mask)
    if not slots.size:
        return 0.0
    lm = np.asarray(cand["landmarks"])[slots].astype(np.float32)
    expected = reference.embed(frame, lm)
    got = torch.as_tensor(np.asarray(cand["embeddings"])[slots],
                          dtype=torch.float32, device=expected.device)
    return float((1.0 - (got * expected).sum(-1)).max())


def _peak_gaps(heat, peaks, cfg):
    """The peak tables of one frame against the reference x8 heatmaps
    (P, H, W): scores, maxima and recall."""
    coords, scores, valid = (np.asarray(a) for a in peaks)
    threshold, k = cfg["keypoint_threshold"], cfg["max_peaks"]
    parts, h, w = heat.shape
    dev = heat.device
    padded = F.pad(heat, (1, 1, 1, 1), value=float("-inf"))
    neighbours = torch.stack([padded[:, :-2, 1:-1], padded[:, 2:, 1:-1],
                              padded[:, 1:-1, :-2], padded[:, 1:-1, 2:]]
                             ).amax(0)
    maxima = ref.local_maxima(heat, threshold)
    # Rows (columns) of the heatmap, -inf beyond its edges, each pixel the
    # maximum of the 2 RING_PX + 1 pixels centred on it along the row
    # (column): the four sides of the ring around a pixel.
    r = RING_PX
    wide = F.pad(heat[None], (r, r, r, r), value=float("-inf"))
    along_x = F.max_pool2d(wide, (1, 2 * r + 1), stride=1)[0]
    along_y = F.max_pool2d(wide, (2 * r + 1, 1), stride=1)[0]
    gaps = dict.fromkeys(PEAKS, 0.0)
    for p in range(parts):
        sel = np.flatnonzero(valid[p])
        y = torch.as_tensor(coords[p, sel, 0], device=dev).long()
        x = torch.as_tensor(coords[p, sel, 1], device=dev).long()
        if not bool(((y >= 0) & (y < h) & (x >= 0) & (x < w)).all()):
            return dict.fromkeys(PEAKS, 1.0)
        at = heat[p, y, x]
        ry, rx = torch.nonzero(maxima[p], as_tuple=True)
        ring = torch.stack([along_x[p, ry, rx], along_x[p, ry + 2 * r, rx],
                            along_y[p, ry, rx], along_y[p, ry, rx + 2 * r]]
                           ).amax(0)
        short = heat[p, ry, rx] - torch.maximum(
            ring, at.min() if sel.size >= k
            else torch.tensor(threshold, device=dev))
        if sel.size:
            got = torch.as_tensor(scores[p, sel], device=dev)
            gaps["peak_score_gap"] = max(gaps["peak_score_gap"], float(
                (got - at).abs().max()))
            below = torch.maximum(neighbours[p, y, x] - at, threshold - at)
            gaps["peak_max_gap"] = max(gaps["peak_max_gap"],
                                       float(below.clamp(min=0).max()))
            near = torch.maximum((ry[:, None] - y[None]).abs(),
                                 (rx[:, None] - x[None]).abs()) <= COVER_PX
            cover = torch.where(near, heat[p, ry, rx][:, None] - at[None],
                                torch.tensor(float("inf"), device=dev))
            short = torch.minimum(short, cover.amin(1))
        if short.numel():
            gaps["peak_miss_gap"] = max(gaps["peak_miss_gap"],
                                        float(short.clamp(min=0).max()))
    return gaps


def track_mismatches(streams, max_age, min_hits):
    """Tracker outputs that differ from the reference SORT. ``streams``:
    {stream: [(input boxes, [(box, track id)] output) per update]}. Track
    ids are compared through a one-to-one map built as they appear."""
    bad = 0
    for calls in streams.values():
        sort, ids, back = Sort(max_age, min_hits), {}, {}
        for boxes, got in calls:
            want = [(tuple(np.asarray(boxes[f]).tolist()), t)
                    for f, t in sort.update(boxes)]
            ok = len(want) == len(got)
            for (wb, wt), (gb, gt) in zip(want, got):
                ok = ok and wb == tuple(np.asarray(gb).tolist())
                ok = (ok and ids.setdefault(gt, wt) == wt
                      and back.setdefault(wt, gt) == gt)
            bad += not ok
    return bad
