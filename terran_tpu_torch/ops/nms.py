"""Fixed-size masked non-maximum suppression.

The port of ``terran_tpu/ops/nms.py``: pre-select the top-K candidates by
score, run greedy suppression over them, return fixed-shape outputs and a
keep mask. The IoU and the greedy order match torchvision's NMS, which
the reference detector calls, so the kept set equals the reference's
whenever at most K candidates clear the score threshold.

The suppression is :func:`suppress`: for a CUDA tensor two launches of
``csrc/nms.cu`` (built by ``nvcc`` at first use), the IoU bitmask of
every pair in 64-candidate tiles (:func:`iou_mask` launches it alone;
its plain version is :func:`iou_mask_plain`), then the greedy sweep over
it in 64-candidate chunks; for a CPU tensor its plain version,
:func:`suppress_plain`, which is the reference's ``fori_loop`` body
written out. :func:`make_sharded_nms` merges candidates pre-selected on
the ranks of a ``parallel.mesh.Mesh`` and runs :func:`nms_fixed` on them.
"""

import ctypes

import numpy as np
import torch

_SOURCE = "nms.cu"
WORD = 64  # candidates per mask word and sweep chunk (csrc/nms.cu: kTile)
_lib = None


def iou_matrix(boxes_a, boxes_b):
    """Pairwise IoU of (..., A, 4) and (..., B, 4) boxes in (x1, y1, x2,
    y2) form -> (..., A, B) float32, in the operation order of
    ``terran_tpu/ops/nms.py::iou_matrix``."""
    area_a = ((boxes_a[..., 2] - boxes_a[..., 0])
              * (boxes_a[..., 3] - boxes_a[..., 1]))
    area_b = ((boxes_b[..., 2] - boxes_b[..., 0])
              * (boxes_b[..., 3] - boxes_b[..., 1]))
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def suppress_plain(boxes, valid, iou_threshold):
    """Greedy suppression over (N, K, 4) pre-selected boxes in descending
    score order with (N, K) validity -> (N, K) keep mask: candidate i, if
    not suppressed and valid, suppresses every later candidate whose IoU
    with it exceeds the threshold (``nms.py:82-91``)."""
    n, k = valid.shape
    ious = iou_matrix(boxes, boxes)
    later = torch.arange(k, device=boxes.device)
    suppressed = torch.zeros((n, k), dtype=torch.bool, device=boxes.device)
    for i in range(k):
        keep_i = ~suppressed[:, i] & valid[:, i]
        row = ious[:, i] > iou_threshold
        suppressed |= keep_i[:, None] & row & (later > i)
    return ~suppressed & valid


def _pack(bits):
    """(..., K) bool -> (..., ceil(K / 64)) int64 words: bit b of word w is
    bits[..., 64 w + b]; bits past K are 0."""
    k = bits.shape[-1]
    words = -(-k // WORD)
    bits = torch.nn.functional.pad(bits.to(torch.int64),
                                   (0, words * WORD - k))
    weights = torch.from_numpy(
        (np.uint64(1) << np.arange(WORD, dtype=np.uint64)).view(np.int64)
    ).to(bits.device)
    return (bits.reshape(bits.shape[:-1] + (words, WORD)) * weights).sum(-1)


def iou_mask_plain(boxes, iou_threshold):
    """The mask kernel's plain version: (N, K, 4) boxes -> (N, K, W) int64
    words, W = ceil(K / 64); bit b of mask[n, i, w] is set iff j = 64 w + b
    has j > i and IoU(i, j) above the threshold."""
    idx = torch.arange(boxes.shape[1], device=boxes.device)
    over = iou_matrix(boxes, boxes) > iou_threshold
    return _pack(over & (idx[None, :] > idx[:, None]))


def _library():
    global _lib
    if _lib is None:
        from terran_tpu_torch.utils.cuda_build import load_library

        lib = load_library(_SOURCE)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nms_mask.argtypes = [ptr, i32, i32, f32, ptr, ptr]
        lib.nms_suppress.argtypes = [ptr, ptr, i32, i32, f32, ptr, ptr, ptr]
        for fn in (lib.nms_mask, lib.nms_suppress):
            fn.restype = i32
        _lib = lib
    return _lib


def _on_cpu(boxes, valid=None):
    """Raise on inputs that no version takes; True for CPU tensors (the
    plain versions), False for CUDA ones (the kernels)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"expected (N, K, 4) boxes, got {tuple(boxes.shape)}")
    if valid is not None and tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"valid {tuple(valid.shape)} does not match boxes "
                         f"{tuple(boxes.shape)}")
    if boxes.device.type == "cpu":
        return True
    if boxes.device.type != "cuda" or (valid is not None
                                       and valid.device != boxes.device):
        raise ValueError(f"no NMS kernel for boxes on {boxes.device}"
                         + ("" if valid is None
                            else f" and valid on {valid.device}"))
    return False


def _launch(name, boxes, *args):
    """``lib.<name>`` on ``args`` and the current stream of ``boxes``'s
    card; raises on its CUDA error."""
    with torch.cuda.device(boxes.device):
        err = getattr(_library(), name)(
            *args, torch._C._cuda_getCurrentRawStream(boxes.device.index))
    if err != 0:
        raise RuntimeError(f"NMS {name} failed at N={boxes.shape[0]}, "
                           f"K={boxes.shape[1]}: CUDA error {err}")


def _mask_buffer(n, k, device):
    """The mask kernel's output, (n, W, 64 W) int64, column-major: mask[n,
    w, i] is row i's word w, so that a chunk's rows of one column are 512
    contiguous bytes."""
    words = -(-k // WORD)
    return torch.empty((n, words, words * WORD), dtype=torch.int64,
                       device=device)


def iou_mask(boxes, iou_threshold):
    """:func:`iou_mask_plain` for a CPU tensor; the mask kernel alone for a
    CUDA tensor, so that it can be checked apart. The kernel leaves the
    words left of a row's own chunk (w < i // 64) unset: the sweep never
    reads them."""
    if _on_cpu(boxes):
        return iou_mask_plain(boxes, iou_threshold)
    n, k = boxes.shape[:2]
    mask = _mask_buffer(n, k, boxes.device)
    if n * k:
        boxes = boxes.to(torch.float32).contiguous()
        _launch("nms_mask", boxes, boxes.data_ptr(), n, k,
                float(iou_threshold), mask.data_ptr())
    return mask[..., :k].transpose(1, 2)


def suppress(boxes, valid, iou_threshold):
    """:func:`suppress_plain` for a CPU tensor; for a CUDA tensor the mask
    kernel, then the sweep kernel."""
    if _on_cpu(boxes, valid):
        return suppress_plain(boxes, valid, iou_threshold)
    n, k = valid.shape
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    if n * k == 0:
        return keep
    boxes = boxes.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    mask = _mask_buffer(n, k, boxes.device)
    _launch("nms_suppress", boxes, boxes.data_ptr(), valid.data_ptr(), n, k,
            float(iou_threshold), mask.data_ptr(), keep.data_ptr())
    suppress.launches += 1
    return keep


# Calls of suppress that launched the two kernels since the count was
# last set to 0.
suppress.launches = 0


def nms_fixed(boxes, scores, iou_threshold, score_threshold=0.0, top_k=256):
    """Greedy NMS with fixed-size outputs, per image.

    boxes (N, A, 4) and scores (N, A) float, or (A, 4) and (A,) for one
    image. Candidates below ``score_threshold`` are masked out; the top
    ``top_k`` by score are kept in descending order, ties to the lower
    index as ``jax.lax.top_k`` does (a stable descending sort), and padded
    with -inf scores when A < top_k.

    Returns (boxes (N, K, 4), scores (N, K), keep (N, K) bool, order (N, K)
    int64 indices into the inputs, overflow (N,) bool): ``overflow`` is set
    where more than ``top_k`` candidates cleared the score threshold, i.e.
    the pre-selection dropped real candidates.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    n, a = scores.shape
    above = scores >= score_threshold
    overflow = above.sum(dim=1) > top_k
    masked = torch.where(above, scores, float("-inf"))
    k = min(top_k, a)
    top_scores, order = torch.sort(masked, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    if k < top_k:
        top_scores = torch.nn.functional.pad(top_scores, (0, top_k - k),
                                             value=float("-inf"))
        order = torch.nn.functional.pad(order, (0, top_k - k))
    top_boxes = boxes.gather(1, order[..., None].expand(n, top_k, 4))
    valid = torch.isfinite(top_scores)
    keep = suppress(top_boxes, valid, iou_threshold)
    out = (top_boxes, top_scores, keep, order, overflow)
    return tuple(t[0] for t in out) if single else out


def make_sharded_nms(mesh, axis_name="data", *, iou_threshold=0.4,
                     score_threshold=0.5, local_top_k=128, top_k=256):
    """NMS for one image whose anchors are split over the mesh's ranks.

    Each rank pre-selects its local top-``local_top_k`` candidates from its
    anchor shard (a stable descending sort, as ``jax.lax.top_k`` orders
    ties), an all-gather in rank order assembles them, and every rank runs
    :func:`nms_fixed` on the merged set, so that every rank returns the
    same outputs.

    Exact against single-device NMS whenever no more than ``local_top_k``
    above-threshold candidates live on any one shard: greedy NMS only
    keeps candidates that also survive the local pre-selection. The
    returned ``overflow`` covers both failure modes: a shard dropping
    above-threshold candidates (all-reduced over the ranks) and the merged
    set exceeding ``top_k``.

    Returns a function (boxes (A, 4), scores (A,)) -> the five outputs of
    :func:`nms_fixed` for one image, with ``order`` indexing the gathered
    arrays. Each rank takes its rows of global arrays (``A`` divisible by
    the mesh size), or its own rows from a ``ShardedBatch``
    (``parallel.mesh.global_batch_from_local``). Every rank calls it.
    """
    from terran_tpu_torch.parallel.mesh import (
        ShardedBatch, all_gather_rows, all_reduce_max,
    )

    def local(values):
        if isinstance(values, ShardedBatch):
            return values.local
        if len(values) % mesh.size:
            raise ValueError(f"{len(values)} anchors do not split over "
                             f"{mesh.size} ranks")
        per = len(values) // mesh.size
        values = values[mesh.rank * per:(mesh.rank + 1) * per]
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.ascontiguousarray(values))
        return values.to(mesh.device)

    def run(boxes, scores):
        boxes, scores = local(boxes), local(scores)
        if len(scores) < local_top_k:
            raise ValueError(f"local_top_k={local_top_k} exceeds the "
                             f"{len(scores)} anchors of a shard")
        above = scores >= score_threshold
        masked = torch.where(above, scores, float("-inf"))
        top_scores, idx = torch.sort(masked, descending=True, stable=True)
        idx = idx[:local_top_k]
        # One gather of (box, score) rows in rank order.
        gathered = all_gather_rows(
            torch.cat([boxes[idx], top_scores[:local_top_k, None]], dim=1),
            mesh)
        local_overflow = (above.sum() > local_top_k).to(torch.int32)
        any_local_overflow = all_reduce_max(local_overflow, mesh) > 0
        kb, ks, keep, order, merged_overflow = nms_fixed(
            gathered[:, :4], gathered[:, 4], iou_threshold,
            score_threshold=score_threshold, top_k=top_k,
        )
        return kb, ks, keep, order, merged_overflow | any_local_overflow

    return run


def nms_numpy_reference(boxes, scores, iou_threshold):
    """O(n^2) numpy greedy NMS, the test oracle (copied from
    ``terran_tpu/ops/nms.py``)."""
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(scores), bool)
    for idx in order:
        if suppressed[idx]:
            continue
        keep.append(idx)
        for jdx in order:
            if jdx == idx or suppressed[jdx]:
                continue
            if scores[jdx] <= scores[idx]:
                x1 = max(boxes[idx, 0], boxes[jdx, 0])
                y1 = max(boxes[idx, 1], boxes[jdx, 1])
                x2 = min(boxes[idx, 2], boxes[jdx, 2])
                y2 = min(boxes[idx, 3], boxes[jdx, 3])
                inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
                area_i = (boxes[idx, 2] - boxes[idx, 0]) * (
                    boxes[idx, 3] - boxes[idx, 1]
                )
                area_j = (boxes[jdx, 2] - boxes[jdx, 0]) * (
                    boxes[jdx, 3] - boxes[jdx, 1]
                )
                union = area_i + area_j - inter
                if union > 0 and inter / union > iou_threshold:
                    suppressed[jdx] = True
    return np.array(keep, dtype=np.int64)
