"""OpenPose wrapper: device forward + decode, host assembly.

The port of ``terran_tpu/pose/openpose.py`` (reference wrapper:
openpose/wrapper.py:166-485). One batched decode runs the CPM forward, the
fused x8 upsample + peak scan, the PAF x8 upsample and all 19 limbs' line
integrals on the device; only fixed-shape score and validity tensors come
back to the host, where greedy matching and human assembly finish.
"""

import numpy as np
import torch

from terran_tpu_torch.checkpoint import load_checkpoint_params
from terran_tpu_torch.config import get_config
from terran_tpu_torch.models import FAMILIES, load_model
from terran_tpu_torch.ops.pose_decode import (
    make_pose_decode, unpack_pose_outputs,
)
from terran_tpu_torch.pose.assembly import assemble_humans, get_keypoints
from terran_tpu_torch.runtime import (
    check_precision, default_policy, resolve_device,
)
from terran_tpu_torch.utils.batching import resize_factory
from terran_tpu_torch.utils.profiling import get_logger


class OpenPoseEstimator:

    CHECKPOINT_CLASS = FAMILIES["openpose"].checkpoint

    def __init__(self, params=None, short_side=None, compute_dtype=None,
                 device=None, max_peaks=None, max_escalations=None,
                 use_fused_peaks=None, pose_precision=None):
        """``params``: a :class:`BodyPoseModel` state dict (default: the
        converted checkpoint store). ``device``: where the model runs,
        the CUDA card unless the caller names another (``"cpu"``).
        ``pose_precision``: 'native' (default: config ``pose_precision``)
        or 'int8', the int8 CPM quantised from the float32 ``params``."""
        cfg = get_config()
        self.pose_precision = check_precision(
            "pose_precision",
            cfg.pose_precision if pose_precision is None else pose_precision,
        )
        short_side = cfg.pose_short_side if short_side is None else short_side
        max_peaks = (
            cfg.max_peaks_per_part if max_peaks is None else max_peaks
        )
        # Overflow escalation: re-run at doubled max_peaks when a part
        # heatmap saturates the fixed peak capacity (the reference's
        # dynamic peak lists cannot drop peaks, wrapper.py:235-262).
        self.max_escalations = (
            cfg.max_escalations if max_escalations is None
            else max_escalations
        )
        self.escalation_count = 0
        if params is None:
            params = load_checkpoint_params(self.CHECKPOINT_CLASS)
        self.device = resolve_device(device)
        self.model = load_model(
            "openpose", params,
            compute_dtype or default_policy().compute_dtype, self.device,
            self.pose_precision)
        self.short_side = short_side
        self.max_peaks = max_peaks
        self.use_fused_peaks = use_fused_peaks

        # Thresholds (reference wrapper.py:177-180), via the config.
        self.keypoint_threshold = cfg.keypoint_threshold
        self.thresh_2 = cfg.paf_midpoint_threshold
        self.human_threshold = cfg.human_score_threshold
        self.downsampling_ratio = 8

        self._decode_fns = {}
        self._resize_in, _ = resize_factory(
            short_side=short_side, device=self.device
        )

    def _decode_fn(self, max_peaks=None):
        max_peaks = self.max_peaks if max_peaks is None else max_peaks
        if max_peaks not in self._decode_fns:
            self._decode_fns[max_peaks] = make_pose_decode(
                self.model,
                keypoint_threshold=self.keypoint_threshold,
                thresh_midpoint=self.thresh_2,
                max_peaks=max_peaks,
                downsampling_ratio=self.downsampling_ratio,
                use_fused_peaks=self.use_fused_peaks,
            )
        return self._decode_fns[max_peaks]

    def decode(self, images):
        """Resize + device decode with overflow escalation. Returns the
        host arrays (coords, scores, valid, reg, accept, overflow) and the
        resize scale."""
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        resized, scale = self._resize_in(images)

        max_peaks = self.max_peaks
        for attempt in range(self.max_escalations + 1):
            peaks, limbs = self._decode_fn(max_peaks)(resized)
            outputs = unpack_pose_outputs(
                peaks.cpu().numpy(), limbs.cpu().numpy()
            )
            overflow = outputs[-1]
            if not overflow.any() or attempt == self.max_escalations:
                break
            # Saturated: weakest peaks were dropped. Re-run at doubled
            # capacity.
            max_peaks *= 2
            self.escalation_count += 1
        if overflow.any():
            get_logger().warning(
                "pose max_peaks=%d saturated on %d part heatmap(s) even "
                "after %d escalation(s); weakest peaks were dropped — raise "
                "max_peaks_per_part or max_escalations",
                max_peaks, int(overflow.sum()), self.max_escalations,
            )
        return outputs, scale

    def call(self, images):
        """Run pose estimation on an (N, H, W, 3) uint8 RGB batch.

        Returns, per image, a list of ``{'keypoints': (18, 3) int32,
        'score': float}`` dicts — the reference contract (wrapper.py:37-90).
        """
        (coords, scores, valid, reg, accept, _), scale = self.decode(images)
        batch_objects = []
        for i in range(coords.shape[0]):
            peaks_by_id, humans = assemble_humans(
                coords[i], scores[i], valid[i], reg[i], accept[i],
                human_threshold=self.human_threshold,
            )
            batch_objects.append(get_keypoints(peaks_by_id, humans, scale))
        return batch_objects
