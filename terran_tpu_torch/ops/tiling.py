"""Tiled detection for very large frames.

The port of ``terran_tpu/ops/tiling.py``. The task APIs resize every input
to a short side of ~416 px, so a 4K/8K frame loses most of its small
faces. Here the frame is split into overlapping tiles at native
resolution, the detector runs over the tile batch, the boxes are mapped
back to global coordinates, and one global NMS merges the duplicates from
the overlap margins.

Detections are equivalent to whole-image inference for any face whose
receptive context fits inside a tile (the overlap must exceed the largest
expected face).

``tile_layout`` and ``extract_tiles`` are copies; ``extract_tiles_device``
slices the tiles from the frame where it lies, so the frame crosses to the
card once at native size. The global merge is :func:`nms_fixed` on the
detector's device: on the card it launches the NMS kernels.
"""

import numpy as np
import torch

from terran_tpu_torch.ops.nms import nms_fixed


def tile_layout(height, width, tile=1024, overlap=256):
    """Static tile origins covering (height, width).

    Tiles are ``tile`` squares placed every ``tile - overlap`` pixels, with
    the final row/column clamped so every tile lies fully inside the image
    (images smaller than ``tile`` get a single clamped tile).
    """
    if overlap >= tile:
        raise ValueError("overlap must be smaller than tile")
    stride = tile - overlap

    def starts(size):
        if size <= tile:
            return [0]
        last = size - tile
        out = list(range(0, last, stride))
        out.append(last)
        return out

    return [(y, x) for y in starts(height) for x in starts(width)]


def extract_tiles(image, origins, tile=1024):
    """Stack tiles into a (T, tile, tile, C) batch, zero-padding tiles that
    extend past a small image."""
    h, w = image.shape[:2]
    batch = np.zeros((len(origins), tile, tile, image.shape[2]),
                     dtype=image.dtype)
    for idx, (y, x) in enumerate(origins):
        ys = min(tile, h - y)
        xs = min(tile, w - x)
        batch[idx, :ys, :xs] = image[y: y + ys, x: x + xs]
    return batch


def extract_tiles_device(image, origins, tile=1024):
    """:func:`extract_tiles` on the frame's device: ``image`` is an (H, W,
    C) tensor (an array is taken as a CPU tensor); returns a (T, tile,
    tile, C) tensor on its device. A frame smaller than a tile is padded
    with zeros first; origins past the frame are clamped so each tile
    fits, as ``jax.lax.dynamic_slice`` clamps them in the JAX package."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image))
    h, w, c = image.shape
    ph, pw = max(h, tile), max(w, tile)
    if (ph, pw) != (h, w):
        padded = torch.zeros((ph, pw, c), dtype=image.dtype,
                             device=image.device)
        padded[:h, :w] = image
        image = padded
    return torch.stack([
        image[y: y + tile, x: x + tile]
        for y, x in ((min(y, ph - tile), min(x, pw - tile))
                     for y, x in origins)
    ])


class TiledDetector:
    """Native-resolution face detection on arbitrarily large frames.

    Wraps a :class:`~terran_tpu_torch.face.detection.RetinaFaceDetector`:
    the tile batch runs through its detect step at one shape for any image
    size, and a final fixed-K NMS on its device merges the per-tile
    results in global coordinates.
    """

    def __init__(self, detector, tile=1024, overlap=256, top_k=256,
                 nms_threshold=0.4, device_tiles=None):
        self.detector = detector
        self.tile = tile
        self.overlap = overlap
        self.top_k = top_k
        self.nms_threshold = nms_threshold
        # The tile must be a shape the detector runs unpadded: a multiple
        # of 32 (the coarsest anchor stride) in 'exact' bucketing, and of
        # the 64 px bucket granularity in 'pad' mode.
        multiple = 64 if getattr(detector, "bucketing", "exact") == "pad" \
            else 32
        if tile % multiple:
            raise ValueError(
                f"tile must be a multiple of {multiple} for a detector "
                f"with bucketing={getattr(detector, 'bucketing', 'exact')!r} "
                "so tile batches skip padding"
            )
        self.device_tiles = (
            device_tiles if device_tiles is not None else True
        )

    def __call__(self, image, threshold=0.5):
        """Detect on one (H, W, 3) uint8 image; returns the task-API list of
        ``{'bbox', 'landmarks', 'score'}`` dicts in global pixel coords."""
        image = np.asarray(image)
        origins = tile_layout(image.shape[0], image.shape[1],
                              self.tile, self.overlap)
        device = self.detector.device
        if self.device_tiles:
            tiles = extract_tiles_device(
                torch.from_numpy(np.ascontiguousarray(image)).to(device),
                origins, self.tile)
        else:
            tiles = extract_tiles(image, origins, self.tile)

        per_tile = self.detector.call(tiles, threshold=threshold)

        boxes, landmarks, scores = [], [], []
        for (y, x), faces in zip(origins, per_tile):
            for face in faces:
                box = np.asarray(face["bbox"], dtype=np.float32)
                lmk = np.asarray(face["landmarks"], dtype=np.float32)
                boxes.append(box + [x, y, x, y])
                landmarks.append(lmk + [x, y])
                scores.append(face["score"])

        if not boxes:
            return []

        boxes = np.stack(boxes)
        landmarks = np.stack(landmarks)
        scores = np.asarray(scores, dtype=np.float32)

        # Merge overlap duplicates with one global NMS, the candidates
        # padded to a power-of-two bucket and top_k fixed. The padding is
        # kept only for parity with the JAX package (where each distinct
        # count would compile a program); nothing here builds per shape.
        bucket = 1
        while bucket < len(boxes):
            bucket *= 2
        if bucket > len(boxes):
            pad = bucket - len(boxes)
            boxes = np.concatenate([boxes, np.zeros((pad, 4), np.float32)])
            scores = np.concatenate([scores, np.full(pad, -1, np.float32)])

        # On the detector's device: CPU tensors would take the plain
        # suppression on the host. float32, as the JAX package merges.
        kb, ks, keep, order, _overflow = nms_fixed(
            torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(scores).to(device), self.nms_threshold,
            score_threshold=threshold, top_k=self.top_k,
        )
        kb = kb.cpu().numpy()
        ks = ks.cpu().numpy()
        keep = keep.cpu().numpy()
        order = order.cpu().numpy()

        return [
            {
                "bbox": kb[i],
                "landmarks": landmarks[order[i]],
                "score": ks[i],
            }
            for i in np.flatnonzero(keep)
        ]
