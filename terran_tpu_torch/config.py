"""Central configuration: every threshold, capacity and default in one place.

The same fields, defaults and ``TERRAN_TPU_<FIELD>`` environment overrides
as ``terran_tpu/config.py``, so one environment configures both packages.
This package reads every field but ``pipeline_embed_windows``, which sizes
the JAX package's windowed embed warp and is kept so that it parses the
same way.
"""

import os
from dataclasses import dataclass, fields


@dataclass(frozen=True)
class Config:
    # Task defaults (reference-compatible).
    detection_short_side: int = 416
    pose_short_side: int = 184
    recognition_crop_side: int = 112

    # Detection decode.
    detection_threshold: float = 0.5
    nms_iou_threshold: float = 0.4
    detection_top_k: int = 256

    # Pose decode.
    keypoint_threshold: float = 0.1
    paf_midpoint_threshold: float = 0.05
    human_score_threshold: float = 0.4
    max_peaks_per_part: int = 32

    # Fused pipeline capacities and dispatch (pipeline.py).
    pipeline_top_k: int = 128
    pipeline_max_faces: int = 16
    pipeline_depth: int = 2
    embed_dispatch: str = "auto"
    pipeline_embed_buckets: str = "2,4,8"
    limb_dispatch: str = "auto"
    pose_peak_buckets: str = "4,8"
    limb_backend: str = "auto"
    pipeline_embed_windows: str = "256,512"
    transfer_plan: str = "device"
    host_resize: str = "auto"

    # Overflow escalation: when a part heatmap saturates ``max_peaks``,
    # re-run that batch at doubled capacity, up to this many doublings
    # (0 = warn only).
    max_escalations: int = 2

    # I/O buffering (io/video).
    reader_buffer_batches: int = 1
    writer_buffer_frames: int = 64
    writer_drain_timeout_s: float = 30.0
    device_prefetch_depth: int = 2

    # Numerics.
    compute_dtype: str = "bfloat16"
    embed_precision: str = "native"
    pose_precision: str = "native"

    # Pose peak finding: 'auto' and 'on' run the fused upsample + peak-scan
    # (the CUDA kernel for CUDA tensors, its plain version for CPU
    # tensors); 'off' materialises the x8 heatmaps and runs find_peaks.
    fused_peaks: str = "auto"

    # Shape policy: 'exact' (one program per shape) or 'pad' (64px buckets).
    bucketing: str = "exact"


def _coerce(value, target_type):
    if target_type is bool:
        return value.lower() in ("1", "true", "yes")
    return target_type(value)


def load_config(env=None):
    """Build a Config, applying ``TERRAN_TPU_<FIELD>`` env overrides."""
    env = os.environ if env is None else env
    overrides = {}
    for field in fields(Config):
        key = f"TERRAN_TPU_{field.name.upper()}"
        if key in env:
            overrides[field.name] = _coerce(env[key], type(field.default))
    return Config(**overrides)


_config = None


def get_config():
    global _config
    if _config is None:
        _config = load_config()
    return _config


def set_config(config):
    global _config
    _config = config
