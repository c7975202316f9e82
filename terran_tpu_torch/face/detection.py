"""Face-detection task API and the RetinaFace wrapper.

The port of ``terran_tpu/face/detection.py`` (reference:
face/detection/__init__.py and retinaface/wrapper.py:92-238): the same
constructor, the same call pipeline (resize_in -> merge_in -> model.call
-> merge_out -> resize_out) and the same ``{'bbox', 'landmarks',
'score'}`` results. Forward, anchor decode and masked NMS run on the
device; one packed array per call comes back to the host.
"""

import threading

import numpy as np
import torch

from terran_tpu_torch.checkpoint import (
    get_class_for_checkpoint, load_checkpoint_params,
)
from terran_tpu_torch.config import get_config
from terran_tpu_torch.models import FAMILIES, load_model
from terran_tpu_torch.models.retinaface import (
    make_detect_fn, unpack_detections,
)
from terran_tpu_torch.runtime import (
    bucket_shape, default_policy, resolve_device,
)
from terran_tpu_torch.utils.batching import merge_factory, resize_factory
from terran_tpu_torch.utils.profiling import get_logger

TASK_NAME = "face-detection"


class RetinaFaceDetector:
    """RetinaFace detection wrapper; one detect step per (padded shape,
    top_k)."""

    CHECKPOINT_CLASS = FAMILIES["retinaface"].checkpoint

    def __init__(self, params=None, nms_threshold=None, top_k=None,
                 bucketing=None, compute_dtype=None, device=None,
                 threshold=None, max_escalations=None):
        """``params``: a :class:`RetinaFace` state dict (default: the
        converted checkpoint store). ``device``: where the model runs, the
        CUDA card unless the caller names another (``"cpu"``)."""
        cfg = get_config()
        self.nms_threshold = (
            cfg.nms_iou_threshold if nms_threshold is None else nms_threshold
        )
        # Overflow escalation: re-run at doubled top_k when the fixed
        # pre-selection saturates, instead of dropping low-scoring faces
        # (the reference's dynamic shapes cannot drop detections,
        # retinaface/wrapper.py:207-236).
        self.max_escalations = (
            cfg.max_escalations if max_escalations is None
            else max_escalations
        )
        self.escalation_count = 0
        # Default score threshold (the reference hardcodes 0.5,
        # wrapper.py:133).
        self.threshold = (
            cfg.detection_threshold if threshold is None else threshold
        )
        self.top_k = cfg.detection_top_k if top_k is None else top_k
        self.bucketing = cfg.bucketing if bucketing is None else bucketing
        if params is None:
            params = load_checkpoint_params(self.CHECKPOINT_CLASS)
        self.device = resolve_device(device)
        self.model = load_model(
            "retinaface", params,
            compute_dtype or default_policy().compute_dtype, self.device)
        self._detect_fns = {}
        # Per-thread device pad buffers, at most 4 shapes: reuse saves an
        # allocation per call, and thread-locality keeps concurrent
        # same-shape calls from sharing one buffer.
        self._pad_local = threading.local()

    def _detect_fn(self, height, width, top_k=None):
        top_k = self.top_k if top_k is None else top_k
        key = (height, width, top_k)
        if key not in self._detect_fns:
            self._detect_fns[key] = make_detect_fn(
                self.model, height, width,
                nms_threshold=self.nms_threshold, top_k=top_k,
            )
        return self._detect_fns[key]

    def _padded(self, images, bh, bw):
        """``images`` (n, h, w, 3) zero-padded to (n, bh, bw, 3) in a
        reused device buffer."""
        n, h, w = images.shape[:3]
        buffers = getattr(self._pad_local, "buffers", None)
        if buffers is None:
            buffers = self._pad_local.buffers = {}
        padded = buffers.get((n, bh, bw))
        if padded is None or padded.dtype != images.dtype:
            if len(buffers) >= 4:
                buffers.pop(next(iter(buffers)))
            padded = torch.zeros((n, bh, bw, 3), dtype=images.dtype,
                                 device=self.device)
            buffers[(n, bh, bw)] = padded
        padded[:, :h, :w] = images
        padded[:, h:, :] = 0
        padded[:, :h, w:] = 0
        return padded

    def call(self, images, threshold=None):
        """Run detection on an (N, H, W, 3) uint8 RGB array or tensor.

        Returns a list (per image) of lists of ``{'bbox': (4,),
        'landmarks': (5, 2), 'score': float32}`` dicts, score-descending:
        the reference wrapper's contract (wrapper.py:233-236).
        """
        if threshold is None:
            threshold = self.threshold
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        images = images.to(self.device)
        n, h, w = images.shape[:3]
        bh, bw = bucket_shape(h, w, mode=self.bucketing)
        if (bh, bw) != (h, w):
            images = self._padded(images, bh, bw)

        top_k = self.top_k
        for attempt in range(self.max_escalations + 1):
            packed = self._detect_fn(bh, bw, top_k)(images, threshold, w, h)
            boxes, landmarks, scores, mask, overflow = unpack_detections(
                packed.cpu().numpy()
            )
            if not overflow.any() or attempt == self.max_escalations:
                break
            # Saturated: the pre-selection may have dropped real faces.
            # Re-run at doubled capacity.
            top_k *= 2
            self.escalation_count += 1
        if overflow.any():
            get_logger().warning(
                "detection top_k=%d saturated on %d image(s) even after %d "
                "escalation(s); results may drop low-scoring faces — raise "
                "detection_top_k or max_escalations",
                top_k, int(overflow.sum()), self.max_escalations,
            )

        batch_objects = []
        for i in range(n):
            keep = mask[i]
            batch_objects.append([
                {"bbox": b, "landmarks": l, "score": s}
                for b, l, s in zip(boxes[i][keep], landmarks[i][keep],
                                   scores[i][keep])
            ])
        return batch_objects


class Detection:
    """Generic detection task (reference Detection,
    face/detection/__init__.py:185-287). Frames are resized on the
    model's device."""

    def __init__(self, checkpoint=None, short_side=None, merge_method="padding",
                 device=None, lazy=False, **model_kwargs):
        if short_side is None:
            short_side = get_config().detection_short_side
        self.device = resolve_device(device)
        self.checkpoint = checkpoint
        self.model_kwargs = model_kwargs
        self.detection_cls = get_class_for_checkpoint(TASK_NAME, checkpoint)

        self.model = (
            self.detection_cls(device=self.device, **model_kwargs)
            if not lazy else None
        )
        self.resize_in, self.resize_out = resize_factory(
            short_side=short_side, device=self.device
        )
        self.merge_in, self.merge_out = merge_factory(method=merge_method)

    def __repr__(self):
        return f"<Detection({self.detection_cls.__name__})>"

    def __call__(self, images):
        expanded = False
        if (
            not isinstance(images, (list, tuple))
            and len(images.shape) == 3
        ):
            expanded = True
            images = images[None]

        images, resize_params = self.resize_in(images)
        images, merge_params = self.merge_in(images)

        if self.model is None:
            self.model = self.detection_cls(
                device=self.device, **self.model_kwargs
            )
        out = self.model.call(images)

        out = self.merge_out(out, merge_params)
        out = self.resize_out(out, resize_params)

        return out[0] if expanded else out


class _LazyDetection:
    """Placeholder so that ``face_detection(image)`` works like the
    reference's lazy singleton without touching the checkpoint store or
    the card on import."""

    _instance = None

    def _resolve(self):
        if self._instance is None:
            self._instance = Detection(lazy=True)
        return self._instance

    def __call__(self, images):
        return self._resolve()(images)

    def __getattr__(self, name):
        # Forward attribute access to the real instance, except for
        # dunder/underscore probes (hasattr, pickling, IPython), which
        # must not load the checkpoint store.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._resolve(), name)


face_detection = _LazyDetection()
"""Default entry point to face detection."""
