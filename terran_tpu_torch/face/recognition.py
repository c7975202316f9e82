"""Face-recognition task API and the ArcFace wrapper.

The port of ``terran_tpu/face/recognition.py`` (reference:
face/recognition/__init__.py and arcface/wrapper.py:102-184): each image's
faces are aligned by a host-side 5-point Umeyama solve and a bilinear warp
on the device, embedded by FaceResNet100 and L2-normalised there; empty
face lists give (0, 512) arrays. The JAX package pads face counts to
powers of two for its compile cache; PyTorch has none to serve, so this
port runs each image's faces as they come.
"""

import numpy as np
import torch

from terran_tpu_torch.checkpoint import (
    get_class_for_checkpoint, load_checkpoint_params,
)
from terran_tpu_torch.config import get_config
from terran_tpu_torch.models.arcface import (
    EMBEDDING_DIM, FaceResNet100, normalize_embeddings,
)
from terran_tpu_torch.ops.warp import alignment_matrices, warp_affine_batch
from terran_tpu_torch.runtime import (
    PARAMS_KEEP_F32, cast_params_for_compute, check_precision,
    default_policy, resolve_device,
)

TASK_NAME = "face-recognition"


class ArcFaceRecognizer:
    """ArcFace embedding wrapper with alignment on the device."""

    CHECKPOINT_CLASS = "terran_tpu_torch.face.recognition.ArcFaceRecognizer"

    def __init__(self, params=None, compute_dtype=None, device=None,
                 image_side=None, embed_precision=None):
        """``params``: a :class:`FaceResNet100` state dict (default: the
        converted checkpoint store). ``device``: where the model runs, the
        CUDA card unless the caller names another (``"cpu"``).
        ``embed_precision``: 'native' (default: config
        ``embed_precision``); 'int8' raises until it is ported."""
        cfg = get_config()
        self.embed_precision = check_precision(
            "embed_precision",
            cfg.embed_precision if embed_precision is None
            else embed_precision,
        )
        if image_side is None:
            image_side = cfg.recognition_crop_side
        if params is None:
            params = load_checkpoint_params(self.CHECKPOINT_CLASS)
        self.device = resolve_device(device)
        dtype = compute_dtype or default_policy().compute_dtype
        # The float32 'embed' projection keeps float32 weights.
        params = cast_params_for_compute(
            params, dtype, keep_f32=PARAMS_KEEP_F32["arcface"]
        )
        model = FaceResNet100().to(dtype=dtype)
        model.embed.to(torch.float32)
        model.load_state_dict(params, strict=True)
        self.model = model.to(self.device).eval()
        self.image_side = image_side

    def _embed(self, crops):
        """Normalised float32 embeddings (K, 512) of (K, S, S, 3) crops
        (array or tensor), as a numpy array."""
        crops = torch.as_tensor(crops, device=self.device)
        with torch.inference_mode():
            feats = normalize_embeddings(self.model(crops))
        return feats.cpu().numpy()

    @staticmethod
    def _alignment_mats(faces):
        return alignment_matrices(np.stack([
            np.asarray(face["landmarks"], dtype=np.float32) for face in faces
        ]))

    def _warp(self, image, mats):
        """Aligned crops of one image, rounded as the reference's PIL warp
        rounds to uint8 (wrapper.py:63-71), on the device."""
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.ascontiguousarray(image))
        crops = warp_affine_batch(image.to(self.device), mats,
                                  out_h=self.image_side,
                                  out_w=self.image_side)
        return torch.round(crops)

    def align(self, image, faces):
        """Every face of one image as an aligned (K, S, S, 3) float32 crop
        (numpy), S the image side (112)."""
        with torch.inference_mode():
            crops = self._warp(image, self._alignment_mats(faces))
        return crops.cpu().numpy()

    def call(self, images, faces_per_image=None):
        """Per image, the (K, 512) float32 normalised embeddings of its
        faces (wrapper.py:109-184)."""
        if faces_per_image is None:
            # The reference resizes and pads each whole image with PIL
            # (wrapper.py:75-99, 149-157); PIL is not on the card's
            # machine, and a port of its resize is queued in ROADMAP.md.
            raise NotImplementedError(
                "recognition without landmarks needs PIL's resize, which "
                "this package has not ported yet (ROADMAP.md, Queue 1)"
            )
        per_image_feats = []
        for image, faces in zip(images, faces_per_image):
            if not faces:
                per_image_feats.append(
                    np.empty((0, EMBEDDING_DIM), np.float32)
                )
                continue
            with torch.inference_mode():
                crops = self._warp(image, self._alignment_mats(faces))
                feats = normalize_embeddings(self.model(crops))
            per_image_feats.append(feats.cpu().numpy())
        return per_image_feats


class Recognition:
    """Generic recognition task (reference Recognition,
    face/recognition/__init__.py:7-90)."""

    def __init__(self, checkpoint=None, device=None, lazy=False,
                 **model_kwargs):
        self.device = resolve_device(device)
        self.model_kwargs = model_kwargs
        self.recognition_cls = get_class_for_checkpoint(TASK_NAME, checkpoint)
        self.model = (
            self.recognition_cls(device=self.device, **model_kwargs)
            if not lazy else None
        )

    def __repr__(self):
        return f"<Recognition({self.recognition_cls.__name__})>"

    def __call__(self, images, faces_per_image=None):
        expanded = False
        if (
            not isinstance(images, (list, tuple))
            and len(images.shape) == 3
        ):
            expanded = True
            images = [images]
            # Expand faces only when given: a single image with no faces
            # takes the no-landmarks branch, as in the JAX package.
            if isinstance(faces_per_image, dict):
                faces_per_image = [[faces_per_image]]
            elif faces_per_image is not None:
                faces_per_image = [faces_per_image]

        if faces_per_image is not None and len(faces_per_image) != len(images):
            raise ValueError(
                f"`images` and `faces_per_image` must be of the same size, "
                f"but the former is of size {len(images)} while the latter of "
                f"size {len(faces_per_image)}."
            )

        if self.model is None:
            self.model = self.recognition_cls(
                device=self.device, **self.model_kwargs
            )
        out = self.model.call(images, faces_per_image)
        return out[0] if expanded else out


class _LazyRecognition:
    _instance = None

    def _resolve(self):
        if self._instance is None:
            self._instance = Recognition(lazy=True)
        return self._instance

    def __call__(self, images, faces_per_image=None):
        return self._resolve()(images, faces_per_image)

    def __getattr__(self, name):
        # Forward attribute access to the real instance, except for
        # dunder/underscore probes (hasattr, pickling, IPython), which
        # must not load the checkpoint store.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._resolve(), name)


extract_features = _LazyRecognition()
"""Default entry point to face recognition."""
