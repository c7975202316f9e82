"""Pose-estimation task API (the port of ``terran_tpu/pose/__init__.py``;
reference: terran/pose/__init__.py)."""

from enum import Enum

import numpy as np

from terran_tpu_torch.checkpoint import get_class_for_checkpoint
from terran_tpu_torch.config import get_config
from terran_tpu_torch.utils.batching import merge_factory

TASK_NAME = "pose-estimation"


class Keypoint(Enum):
    """COCO-order body parts (reference pose/__init__.py:13-36)."""

    NOSE = 0
    NECK = 1

    R_SHOULDER = 2
    R_ELBOW = 3
    R_HAND = 4

    L_SHOULDER = 5
    L_ELBOW = 6
    L_HAND = 7

    R_HIP = 8
    R_KNEE = 9
    R_FOOT = 10

    L_HIP = 11
    L_KNEE = 12
    L_FOOT = 13

    R_EYE = 14
    L_EYE = 15
    R_EAR = 16
    L_EAR = 17


class Estimation:
    """Generic pose-estimation task (reference Estimation,
    pose/__init__.py:131-223). Uses the shared merge util instead of the
    reference's duplicated copy (their TODO at pose/__init__.py:39-40)."""

    def __init__(self, checkpoint=None, short_side=None, merge_method="padding",
                 device=None, lazy=False, **model_kwargs):
        if short_side is None:
            short_side = get_config().pose_short_side
        self.device = device
        self.short_side = short_side
        self.model_kwargs = model_kwargs
        self.estimation_cls = get_class_for_checkpoint(TASK_NAME, checkpoint)

        self.model = (
            self.estimation_cls(
                device=device, short_side=short_side, **model_kwargs
            ) if not lazy else None
        )
        self.merge_in, self.merge_out = merge_factory(
            method=merge_method, coord_keys=("keypoints",)
        )

    def __repr__(self):
        return f"<Estimation({self.estimation_cls.__name__})>"

    def __call__(self, images):
        expanded = False
        if (
            not isinstance(images, (list, tuple))
            and len(images.shape) == 3
        ):
            expanded = True
            images = np.expand_dims(images, 0)

        images, merge_params = self.merge_in(images)

        if self.model is None:
            self.model = self.estimation_cls(
                device=self.device, short_side=self.short_side,
                **self.model_kwargs,
            )
        out = self.model.call(images)

        out = self.merge_out(out, merge_params)
        return out[0] if expanded else out


class _LazyEstimation:
    _instance = None

    def _resolve(self):
        if self._instance is None:
            self._instance = Estimation(lazy=True)
        return self._instance

    def __call__(self, images):
        return self._resolve()(images)

    def __getattr__(self, name):
        # Forward attribute access so the lazy proxy is a drop-in for the
        # real instance (the reference exposes a real object at import) —
        # except dunder/underscore probes (hasattr, pickling, IPython
        # introspection), which must not load the checkpoint store.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._resolve(), name)


pose_estimation = _LazyEstimation()
"""Default entry point to pose estimation."""
