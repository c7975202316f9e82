"""terran_tpu_torch: the PyTorch and CUDA port of terran_tpu.

The same public names as ``terran_tpu`` (``face_detection``,
``Detection``, ``extract_features``, ``Recognition``, ``pose_estimation``,
``Estimation``, ``Keypoint``, ``default_device``, ``open_image``,
``resolve_images``, ``open_video``, ``write_video``, ``face_tracking``,
``display_image``, ``vis_faces``, ``vis_poses``), running on an NVIDIA card
by default. Image loading and drawing need Pillow (or pycairo for
drawing), imported when they are called. Imports are lazy (PEP 562), so
``import terran_tpu_torch`` touches neither the checkpoint store nor the
card.
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
    "open_image": ("terran_tpu_torch.io", "open_image"),
    "resolve_images": ("terran_tpu_torch.io", "resolve_images"),
    "open_video": ("terran_tpu_torch.io", "open_video"),
    "write_video": ("terran_tpu_torch.io", "write_video"),
    "face_tracking": ("terran_tpu_torch.tracking", "face_tracking"),
    "display_image": ("terran_tpu_torch.vis", "display_image"),
    "vis_faces": ("terran_tpu_torch.vis", "vis_faces"),
    "vis_poses": ("terran_tpu_torch.vis", "vis_poses"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module_path, attr = _LAZY[name]
        return getattr(importlib.import_module(module_path), attr)
    raise AttributeError(f"module 'terran_tpu_torch' has no attribute '{name}'")
