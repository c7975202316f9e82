"""Pretrained-checkpoint registry and resolution.

The registry, home directory and ``<id>.npz`` store of
``terran_tpu/checkpoint.py``: both packages read the same converted store
under ``TERRAN_TPU_HOME`` (default ``~/.terran-tpu``), and this one turns
the stored JAX pytrees into state dicts with
:func:`terran_tpu_torch.utils.convert.params_from_jax`. An entry's
``class`` names this package's wrapper: RetinaFace, ArcFace and
OpenPose. Downloading and the CLI are not part of this package yet: a
checkpoint missing from the store raises.
"""

import importlib
import os
from pathlib import Path

from terran_tpu_torch.utils.profiling import get_logger

DEFAULT_HOME = Path("~/.terran-tpu")
CHECKPOINT_DIR = "checkpoints"

# Same ids, tasks and aliases as the reference registry (checkpoint.py:29-103).
CHECKPOINTS = [
    {
        "id": "b5d77fff",
        "name": "RetinaFace",
        "description": "RetinaFace with mnet backbone.",
        "task": "face-detection",
        "class": "terran_tpu_torch.face.detection.RetinaFaceDetector",
        "model_key": "retinaface",
        "alias": "gpu-realtime",
        "default": True,
        "performance": 1.0,
        "evaluation": {"value": 0.76, "metric": "mAP", "is_reported": False},
        "url": (
            "https://github.com/nagitsu/terran/releases/download/0.0.1/"
            "retinaface-mnet.pth"
        ),
    },
    {
        "id": "d206e4b0",
        "name": "ArcFace",
        "description": "ArcFace with Resnet 100 backbone.",
        "task": "face-recognition",
        "class": "terran_tpu_torch.face.recognition.ArcFaceRecognizer",
        "model_key": "arcface",
        "alias": "gpu-realtime",
        "default": True,
        "performance": 0.9,
        "evaluation": {"value": 0.80, "metric": "accuracy",
                       "is_reported": False},
        "url": (
            "https://github.com/nagitsu/terran/releases/download/0.0.1/"
            "arcface-resnet100.pth"
        ),
    },
    {
        "id": "11a769ad",
        "name": "OpenPose",
        "description": (
            "OpenPose with VGG backend, 2017 version. Has some modifications, "
            "improving computational efficiency by giving up mAP."
        ),
        "task": "pose-estimation",
        "class": "terran_tpu_torch.pose.openpose.OpenPoseEstimator",
        "model_key": "openpose",
        "alias": "gpu-realtime",
        "default": True,
        "performance": 1.8,
        "evaluation": {"value": 0.65, "metric": "mAP", "is_reported": True},
        "url": (
            "https://github.com/nagitsu/terran/releases/download/0.0.1/"
            "openpose-body.pth"
        ),
    },
]


def get_home(create_if_missing=True):
    """Framework home dir; override with TERRAN_TPU_HOME (ref: TERRAN_HOME,
    checkpoint.py:118-120)."""
    path = Path(os.environ.get("TERRAN_TPU_HOME", DEFAULT_HOME)).expanduser()
    if create_if_missing:
        path.mkdir(parents=True, exist_ok=True)
    return path


def get_checkpoints_directory():
    path = get_home() / CHECKPOINT_DIR
    path.mkdir(parents=True, exist_ok=True)
    return path


def read_checkpoint_db():
    """Database = registry x filesystem presence (checkpoint.py:145-169)."""
    directory = get_checkpoints_directory()
    local = {p.stem for p in directory.glob("*.npz")}
    checkpoints = [
        {
            "status": "DOWNLOADED" if c["id"] in local else "NOT_DOWNLOADED",
            "local_path": (
                directory / f"{c['id']}.npz" if c["id"] in local else None
            ),
            **c,
        }
        for c in CHECKPOINTS
    ]
    return {"checkpoints": checkpoints}


def get_checkpoint(db, id_or_alias):
    """Resolve by id, or by (task, alias-or-default) tuple (ref :172-210)."""
    if isinstance(id_or_alias, tuple):
        task_name, alias = id_or_alias
        selected = [
            c for c in db["checkpoints"]
            if c["task"] == task_name
            and (c["alias"] == alias if alias is not None else c["default"])
        ]
    else:
        selected = [c for c in db["checkpoints"] if c["id"] == id_or_alias]
    if not selected:
        return None
    if len(selected) > 1:
        get_logger().warning(
            "multiple checkpoints found for %r (%d); returning the first",
            id_or_alias, len(selected),
        )
    return selected[0]


def get_class_for_checkpoint(task_name, alias):
    """Import the wrapper class for a (task, alias) (ref :213-245)."""
    db = read_checkpoint_db()
    checkpoint = get_checkpoint(db, (task_name, alias))
    if not checkpoint:
        raise ValueError("Checkpoint not found.")
    module_path, class_name = checkpoint["class"].rsplit(".", maxsplit=1)
    return getattr(importlib.import_module(module_path), class_name)


def get_checkpoint_by_class(db, class_path):
    selected = [c for c in db["checkpoints"] if c["class"] == class_path]
    return selected[0] if selected else None


def get_checkpoint_path(model_class_path):
    """Local path of the converted weights for a wrapper class."""
    db = read_checkpoint_db()
    checkpoint = get_checkpoint_by_class(db, model_class_path)
    if not checkpoint:
        raise ValueError("Checkpoint not found.")
    if checkpoint["status"] == "NOT_DOWNLOADED":
        raise FileNotFoundError(
            f"checkpoint {checkpoint['id']} ({checkpoint['name']}) is not in "
            f"{get_checkpoints_directory()}; convert the reference .pth into "
            f"the store with `terran-tpu checkpoint convert "
            f"{checkpoint['id']} <file.pth>`"
        )
    return checkpoint["local_path"]


def load_checkpoint_params(model_class_path):
    """State dict (float32 tensors) for a wrapper class, from the store."""
    from terran_tpu_torch.utils.convert import load_params, params_from_jax

    return params_from_jax(load_params(get_checkpoint_path(model_class_path)))
