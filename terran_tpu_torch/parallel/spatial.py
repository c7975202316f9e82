"""Spatial sharding of one large frame across the mesh (halo exchange).

The port of ``terran_tpu/parallel/spatial.py``. The batch mesh
(``parallel.mesh``) scales the number of frames; this module scales one
frame: its rows are split into slabs, rank *i* holds slab *i*, trades
``halo`` boundary rows with its upper and lower neighbours in one
``batch_isend_irecv``, runs RetinaFace on its extended slab, keeps the
anchors whose centres fall inside its own rows, and the per-rank
candidates are merged by the all-gather + fixed-K NMS that
``ops.nms.make_sharded_nms`` uses. No rank holds the whole frame on its
device.

Equivalence to whole-frame inference: slab and halo heights are multiples
of 32, so every extended slab's anchor grid lies on the global stride-32
grid, and an owned anchor's score and box equal the whole-frame result
wherever its receptive field lies inside the extended slab. The ranks at
the frame's top and bottom edges take a zero halo, as ``ppermute``'s
no-source fill gives the JAX program.
"""

import functools

import numpy as np
import torch
import torch.distributed as dist

from terran_tpu_torch.models.retinaface import (
    FEATURE_STRIDES, anchor_cell_meta, anchors_for_shape, decode_outputs,
    unpack_detections,
)
from terran_tpu_torch.ops.nms import nms_fixed
from terran_tpu_torch.parallel.mesh import (
    DATA_AXIS, ShardedBatch, all_gather_rows, all_reduce_max, create_mesh,
    global_batch_from_local, shard_params,
)
from terran_tpu_torch.runtime import PARAMS_KEEP_F32, cast_params_for_compute
from terran_tpu_torch.utils.convert import as_state_dict

# Slab and halo heights must be multiples of the coarsest feature stride so
# every extended slab's anchor grid lands exactly on the global grid.
GRID = max(FEATURE_STRIDES)


def slab_layout(height, n_devices, multiple=GRID):
    """(slab_height, padded_height) for sharding ``height`` rows over
    ``n_devices``: the smallest multiple-of-``multiple`` slab whose
    ``n_devices`` copies cover the frame."""
    slab = -(-height // (n_devices * multiple)) * multiple
    return slab, slab * n_devices


@functools.lru_cache(maxsize=64)
def ext_anchor_meta(slab_h, width, halo):
    """Anchor metadata for one extended slab of shape
    (slab_h + 2*halo, width), as numpy arrays:

    ``anchors`` (A, 4) in extended-slab coordinates, per-anchor feature-map
    ``cell_x``/``cell_y`` indices, ``cell_stride``, and ``ctr_y`` — the
    anchor centre's y in extended-slab coordinates (used for row ownership).
    """
    ext_h = slab_h + 2 * halo
    anchors = anchors_for_shape(ext_h, width)
    cell_x, cell_y, cell_stride = anchor_cell_meta(ext_h, width)
    ctr_y = (anchors[:, 1] + anchors[:, 3]) / 2.0
    return anchors, cell_x, cell_y, cell_stride, ctr_y


@functools.lru_cache(maxsize=64)
def _ext_meta_on(slab_h, width, halo, device):
    """:func:`ext_anchor_meta` as tensors on ``device``, made once."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(a).to(device)
                     for a in ext_anchor_meta(slab_h, width, halo))


def slab_candidates(scores, boxes, landmarks, *, device_index, slab_h, halo,
                    width, valid_h, valid_w, threshold, local_top_k):
    """One rank's owned, globally-positioned top-K candidates.

    Mask to anchors that are (a) inside the valid frame region and (b)
    owned by this slab (anchor centre-y within its rows), shift to global
    coordinates, and pre-select the ``local_top_k`` best by score with a
    stable descending sort (ties to the lower index, as ``jax.lax.top_k``).

    scores (A,), boxes (A, 4), landmarks (A, 5, 2) float32 of the extended
    slab -> (boxes (K, 4), landmarks (K, 5, 2), scores (K,), overflow
    0-d bool), on the inputs' device.
    """
    _, cell_x, cell_y, stride, ctr_y = _ext_meta_on(slab_h, width, halo,
                                                    scores.device)
    start = device_index * slab_h
    offset = float(start - halo)

    # Validity: the anchor's cell, in GLOBAL grid indices, must be one the
    # whole-frame detector would evaluate for the unpadded frame (the
    # ceil-cell rule of models.retinaface.make_detect_fn).
    gy = cell_y + (start - halo) // stride
    valid = ((gy >= 0) & (gy < (valid_h + stride - 1) // stride)
             & (cell_x < (valid_w + stride - 1) // stride))
    # Ownership: anchor centre row inside this slab. Every global anchor is
    # owned by exactly one rank, so the union over the mesh is the exact
    # whole-frame candidate set.
    gctr = ctr_y + offset
    own = (gctr >= start) & (gctr < start + slab_h)
    # -inf, not 0: a threshold <= 0 must not resurrect non-owned anchors
    # as score-0 candidates duplicated across ranks.
    scores = torch.where(valid & own, scores, float("-inf"))

    shift = torch.tensor([0.0, offset], dtype=torch.float32,
                         device=scores.device)
    boxes = boxes + shift.repeat(2)
    landmarks = landmarks + shift

    above = scores >= threshold
    overflow = above.sum() > local_top_k
    masked = torch.where(above, scores, float("-inf"))
    top_scores, idx = torch.sort(masked, descending=True, stable=True)
    idx = idx[:local_top_k]
    # -inf marks empty pre-selection slots; NMS downstream treats them as
    # below any score_threshold.
    return boxes[idx], landmarks[idx], top_scores[:local_top_k], overflow


def _own_slab(frame, mesh, slab_h):
    """This rank's slab of ``frame`` on its device: a global (n * slab_h,
    W, 3) array or tensor, or a :class:`ShardedBatch` of the slab."""
    if isinstance(frame, ShardedBatch):
        return frame.local
    slab = frame[mesh.rank * slab_h:(mesh.rank + 1) * slab_h]
    if not isinstance(slab, torch.Tensor):
        slab = torch.from_numpy(np.ascontiguousarray(slab))
    return slab.to(mesh.device)


def exchange_halos(slab, halo, mesh):
    """(halo + slab_h + halo, W, C): ``slab`` between its upper neighbour's
    last ``halo`` rows and its lower neighbour's first, traded in one
    ``batch_isend_irecv``; the frame's edge ranks take zeros."""
    top = torch.zeros((halo,) + tuple(slab.shape[1:]), dtype=slab.dtype,
                      device=slab.device)
    bottom = torch.zeros_like(top)
    ops = []
    if mesh.rank > 0:
        peer = mesh.ranks[mesh.rank - 1]
        ops += [dist.P2POp(dist.isend, slab[:halo].contiguous(), peer,
                           mesh.group),
                dist.P2POp(dist.irecv, top, peer, mesh.group)]
    if mesh.rank < mesh.size - 1:
        peer = mesh.ranks[mesh.rank + 1]
        ops += [dist.P2POp(dist.isend, slab[-halo:].contiguous(), peer,
                           mesh.group),
                dist.P2POp(dist.irecv, bottom, peer, mesh.group)]
    if ops:
        for request in dist.batch_isend_irecv(ops):
            request.wait()
    return torch.cat([top, slab, bottom], dim=0)


def make_spatial_detect_fn(model, mesh, slab_h, width, halo, *,
                           nms_threshold=0.4, top_k=256, local_top_k=None,
                           axis_name=DATA_AXIS):
    """Build the halo-exchange detection step for one frame shape.

    The returned function maps ``(params, frame, threshold, valid_w,
    valid_h)`` to the packed ``(top_k, 17)`` detection tensor of
    ``models.retinaface.make_detect_fn`` (global pixel coordinates, the
    same on every rank, on the mesh's device). ``params``: the model's
    state dict on the mesh's device (:func:`shard_params`); ``frame``: the
    (n * slab_h, width, 3) uint8 frame, of which each rank takes its own
    slab, or a :class:`ShardedBatch` of this rank's slab. Channel 16
    carries the merged NMS's overflow OR any rank's pre-selection
    overflow. Every rank of ``mesh`` calls it.
    """
    if slab_h % GRID or halo % GRID:
        raise ValueError(f"slab_h and halo must be multiples of {GRID}")
    if halo <= 0:
        raise ValueError("halo must be positive")
    if halo > slab_h:
        # The exchange trades rows with IMMEDIATE neighbours only;
        # slab[-halo:] of a shorter slab would silently ship fewer rows
        # than the anchor grid expects.
        raise ValueError(
            f"halo ({halo}) must not exceed slab_h ({slab_h})"
        )
    if local_top_k is None:
        local_top_k = top_k
    anchors = _ext_meta_on(slab_h, width, halo, mesh.device)[0]

    @torch.inference_mode()
    def run(params, frame, threshold, valid_w, valid_h):
        ext = exchange_halos(_own_slab(frame, mesh, slab_h), halo, mesh)
        outputs = torch.func.functional_call(
            model, params, (ext[None].to(model.compute_dtype),))
        scores, boxes, landmarks = decode_outputs(outputs, anchors)
        lb, ll, ls, local_overflow = slab_candidates(
            scores[0], boxes[0], landmarks[0], device_index=mesh.rank,
            slab_h=slab_h, halo=halo, width=width, valid_h=valid_h,
            valid_w=valid_w, threshold=threshold, local_top_k=local_top_k,
        )
        # One gather of (box 4, landmarks 10, score) rows in rank order.
        gathered = all_gather_rows(
            torch.cat([lb, ll.reshape(-1, 10), ls[:, None]], dim=1), mesh)
        any_overflow = all_reduce_max(local_overflow.to(torch.int32),
                                      mesh) > 0
        kb, ks, keep, order, merged_overflow = nms_fixed(
            gathered[:, :4], gathered[:, 14], nms_threshold,
            score_threshold=threshold, top_k=top_k,
        )
        overflow = (merged_overflow | any_overflow).to(torch.float32)
        return torch.cat([kb, gathered[order, 4:14], ks[:, None],
                          keep[:, None].to(torch.float32),
                          overflow.expand(top_k)[:, None]], dim=-1)

    return run


class SpatialShardedDetector:
    """Native-resolution detection on one frame sharded across the mesh.

    Wraps the model of a
    :class:`~terran_tpu_torch.face.detection.RetinaFaceDetector` (or
    ``params`` and ``model``); the parameters are broadcast from the mesh's
    first rank. Every rank calls it with the same image and gets the
    task-API list of ``{'bbox', 'landmarks', 'score'}`` dicts in global
    pixel coordinates, score-descending.
    """

    def __init__(self, detector=None, *, mesh=None, halo=256, top_k=256,
                 local_top_k=None, nms_threshold=None, params=None,
                 model=None, max_escalations=None):
        if detector is not None:
            params = detector.model.state_dict() if params is None \
                else params
            model = detector.model if model is None else model
            if nms_threshold is None:
                nms_threshold = detector.nms_threshold
        if params is None or model is None:
            raise ValueError("pass a detector, or params and model")
        from terran_tpu_torch.config import get_config

        if nms_threshold is None:
            nms_threshold = get_config().nms_iou_threshold
        # Overflow escalation, as in every other fixed-capacity path: a
        # saturated per-rank pre-selection or merged NMS re-runs the frame
        # at doubled local_top_k/top_k instead of dropping faces.
        self.max_escalations = (
            get_config().max_escalations if max_escalations is None
            else max_escalations
        )
        self.escalations = 0
        self.mesh = mesh if mesh is not None else create_mesh()
        self.n_devices = self.mesh.size
        self.halo = -(-halo // GRID) * GRID
        self.top_k = top_k
        self.local_top_k = local_top_k
        self.nms_threshold = nms_threshold
        params = cast_params_for_compute(
            as_state_dict(params), model.compute_dtype,
            keep_f32=PARAMS_KEEP_F32["retinaface"])
        self.params = shard_params(params, self.mesh)
        self.model = model
        self._fns = {}

    def _fn(self, slab_h, width, top_k=None, local_top_k=None):
        top_k = self.top_k if top_k is None else top_k
        if local_top_k is None:
            local_top_k = self.local_top_k
        key = (slab_h, width, top_k, local_top_k)
        if key not in self._fns:
            # A short frame can make slab_h < the configured halo; the
            # exchange only reaches immediate neighbours, so clamp (the
            # whole neighbouring slab is then in view).
            self._fns[key] = make_spatial_detect_fn(
                self.model, self.mesh, slab_h, width,
                min(self.halo, slab_h),
                nms_threshold=self.nms_threshold, top_k=top_k,
                local_top_k=local_top_k,
            )
        return self._fns[key]

    def _own_slab(self, image, slab_h, padded_w):
        """This rank's slab of ``image`` zero-padded to (n * slab_h,
        padded_w), as a :class:`ShardedBatch`: only its rows are copied."""
        start = self.mesh.rank * slab_h
        slab = np.zeros((slab_h, padded_w) + image.shape[2:], image.dtype)
        rows = image[start:start + slab_h]
        slab[:len(rows), :image.shape[1]] = rows
        return global_batch_from_local(slab, self.mesh)

    def __call__(self, image, threshold=0.5):
        image = np.asarray(image)
        h, w = image.shape[:2]
        slab_h, _ = slab_layout(h, self.n_devices)
        padded_w = -(-w // GRID) * GRID
        slab = self._own_slab(image, slab_h, padded_w)

        # Capacity ceilings: the per-rank pre-selection cannot exceed the
        # extended slab's anchor count, and the merged NMS cannot keep more
        # than the all-gather delivers, so a clamped escalation ends
        # unsaturated.
        n_anchors = len(
            ext_anchor_meta(slab_h, padded_w, min(self.halo, slab_h))[0]
        )

        def _clamp(t, l):
            l = min(l, n_anchors)
            return min(t, self.n_devices * l), l

        def detect(top_k, local_top_k):
            packed = self._fn(slab_h, padded_w, top_k, local_top_k)(
                self.params, slab, threshold, w, h)
            return unpack_detections(packed.cpu().numpy()[None])

        top_k, local_top_k = _clamp(
            self.top_k, self.local_top_k or self.top_k
        )
        boxes, landmarks, scores, mask, overflow = detect(top_k, local_top_k)
        # The overflow flag is the all-reduced one, the same on every rank,
        # so every rank takes each escalation: a rank escalating alone
        # would deadlock the next collective.
        attempts = 0
        while bool(overflow[0]) and attempts < self.max_escalations:
            new_top_k, new_local = _clamp(top_k * 2, local_top_k * 2)
            if (new_top_k, new_local) == (top_k, local_top_k):
                break  # already at the ceiling; re-dispatch cannot help
            attempts += 1
            self.escalations += 1
            top_k, local_top_k = new_top_k, new_local
            boxes, landmarks, scores, mask, overflow = detect(top_k,
                                                              local_top_k)
        if bool(overflow[0]):
            from terran_tpu_torch.utils.profiling import get_logger

            get_logger().warning(
                "spatial detection still saturated after %d escalations "
                "(top_k=%s local_top_k=%s); low-scoring faces may be "
                "dropped — raise max_escalations or top_k",
                attempts, top_k, local_top_k,
            )
        keep = mask[0]
        return [
            {"bbox": b, "landmarks": l, "score": np.float32(s)}
            for b, l, s in zip(boxes[0][keep], landmarks[0][keep],
                               scores[0][keep])
        ]
