"""terran_tpu_torch: the PyTorch and CUDA port of terran_tpu.

The same public names as ``terran_tpu`` for the parts ported so far
(``face_detection``, ``Detection``, ``extract_features``, ``Recognition``,
``pose_estimation``, ``Estimation``, ``Keypoint``, ``default_device``,
``open_video``, ``write_video``, ``face_tracking``), running on an NVIDIA
card by default; image loading and drawing (``open_image``,
``resolve_images``, ``display_image``, ``vis_faces``, ``vis_poses``) are
not ported yet. Imports are lazy (PEP 562), so ``import
terran_tpu_torch`` touches neither the checkpoint store nor the card.
"""

__version__ = "0.1.0"

_LAZY = {
    "default_device": ("terran_tpu_torch.runtime", "default_device"),
    "face_detection": ("terran_tpu_torch.face", "face_detection"),
    "Detection": ("terran_tpu_torch.face", "Detection"),
    "extract_features": ("terran_tpu_torch.face", "extract_features"),
    "Recognition": ("terran_tpu_torch.face", "Recognition"),
    "pose_estimation": ("terran_tpu_torch.pose", "pose_estimation"),
    "Estimation": ("terran_tpu_torch.pose", "Estimation"),
    "Keypoint": ("terran_tpu_torch.pose", "Keypoint"),
    "open_video": ("terran_tpu_torch.io", "open_video"),
    "write_video": ("terran_tpu_torch.io", "write_video"),
    "face_tracking": ("terran_tpu_torch.tracking", "face_tracking"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module_path, attr = _LAZY[name]
        return getattr(importlib.import_module(module_path), attr)
    raise AttributeError(f"module 'terran_tpu_torch' has no attribute '{name}'")
