"""Face-recognition task API and the ArcFace wrapper.

The port of ``terran_tpu/face/recognition.py`` (reference:
face/recognition/__init__.py and arcface/wrapper.py:102-184): each image's
faces are aligned by a host-side 5-point Umeyama solve and a bilinear warp
on the device, embedded by FaceResNet100 and L2-normalised there; empty
face lists give (0, 512) arrays. Without landmarks each whole image is
resized to fit the crop and centred (:func:`preprocess_face_no_landmarks`,
PIL's resize computed on the device). The JAX package pads face counts to
powers of two for its compile cache; PyTorch has none to serve, so this
port runs each image's faces as they come.
"""

import numpy as np
import torch

from terran_tpu_torch.checkpoint import (
    get_class_for_checkpoint, load_checkpoint_params,
)
from terran_tpu_torch.config import get_config
from terran_tpu_torch.models import FAMILIES, load_model
from terran_tpu_torch.models.arcface import EMBEDDING_DIM, normalize_embeddings
from terran_tpu_torch.ops.warp import alignment_matrices, warp_affine_batch
from terran_tpu_torch.runtime import (
    check_precision, default_policy, resolve_device,
)

TASK_NAME = "face-recognition"

# PIL's 8-bit resampling arithmetic (libImaging/Resample.c): coefficients
# in fixed point with PRECISION_BITS fractional bits, sums started at
# half a unit, results shifted down and clipped to 0..255.
_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_A = -0.5
_BICUBIC_SUPPORT = 2.0


def _bicubic(x):
    """PIL's bicubic filter (a = -0.5) at ``x``, in its operation order."""
    x = abs(x)
    if x < 1.0:
        return ((_BICUBIC_A + 2.0) * x - (_BICUBIC_A + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * _BICUBIC_A
    return 0.0


def pil_bicubic_weights(in_size, out_size):
    """(out_size, in_size) float64 matrix of the integer fixed-point
    coefficients PIL's BICUBIC resize of one axis uses, antialiased when it
    shrinks: the filter is stretched by the scale and each output's taps
    are normalised to sum to 1 before they are rounded to fixed point
    (``precompute_coeffs`` and ``normalize_coeffs_8bpc``, computed in the
    same double operations, so the integers are PIL's)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ss = 1.0 / filterscale
    unit = float(1 << _PRECISION_BITS)
    weights = np.zeros((out_size, in_size))
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        taps = [_bicubic((x - center + 0.5) * ss) for x in range(xmin, xmax)]
        total = 0.0
        for w in taps:
            total += w
        for x, w in zip(range(xmin, xmax), taps):
            if total != 0.0:
                w /= total
            weights[xx, x] = int(w * unit - 0.5 if w < 0 else w * unit + 0.5)
    return weights


def _resample(values, weights, dim):
    """One PIL resampling pass of integer ``values`` (float64) along
    ``dim``: the fixed-point sums, shifted and clipped to uint8 counts.
    Every product and partial sum is an integer below 2**53, so float64
    computes them exactly on any device."""
    out = torch.tensordot(values, weights, dims=([dim], [1])).movedim(-1, dim)
    out = out + float(1 << (_PRECISION_BITS - 1))
    return torch.clamp(torch.floor(out / float(1 << _PRECISION_BITS)),
                       0.0, 255.0)


def resize_pil_bicubic(image, width, height):
    """``PIL.Image.fromarray(image).resize((width, height))`` on an (H, W,
    C) uint8 tensor, on its device: BICUBIC, two passes, horizontal first,
    each rounded and clipped to uint8 as PIL's are. Returns a uint8
    tensor."""
    if width <= 0 or height <= 0:
        raise ValueError("height and width must be > 0")
    h, w = image.shape[:2]
    values = image.to(torch.float64)
    for dim, size, out_size in ((1, w, width), (0, h, height)):
        weights = torch.from_numpy(pil_bicubic_weights(size, out_size))
        values = _resample(values, weights.to(image.device), dim)
    return values.to(torch.uint8)


def preprocess_face_no_landmarks(image, image_side=112):
    """Resize-to-side + centre pad fallback when no landmarks are available
    (reference wrapper.py:75-99): the longer side scaled to ``image_side``
    with PIL's default resize, centred on zeros. ``image``: an (H, W, 3)
    uint8 array or tensor; returns an (image_side, image_side, 3) uint8
    tensor on the tensor's device (the CPU for an array)."""
    if not isinstance(image, torch.Tensor):
        image = torch.from_numpy(np.ascontiguousarray(image))
    h, w = image.shape[:2]
    scale = image_side / max(w, h)
    new_w, new_h = int(w * scale), int(h * scale)
    face = resize_pil_bicubic(image, new_w, new_h)

    x_min = int((image_side - new_w) / 2)
    y_min = int((image_side - new_h) / 2)
    out = torch.zeros((image_side, image_side, image.shape[2]),
                      dtype=torch.uint8, device=image.device)
    out[y_min: y_min + new_h, x_min: x_min + new_w] = face
    return out


class ArcFaceRecognizer:
    """ArcFace embedding wrapper with alignment on the device."""

    CHECKPOINT_CLASS = FAMILIES["arcface"].checkpoint

    def __init__(self, params=None, compute_dtype=None, device=None,
                 image_side=None, embed_precision=None):
        """``params``: a :class:`FaceResNet100` state dict (default: the
        converted checkpoint store). ``device``: where the model runs, the
        CUDA card unless the caller names another (``"cpu"``).
        ``embed_precision``: 'native' (default: config
        ``embed_precision``) or 'int8', the int8 trunk quantised from the
        float32 ``params``."""
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
        self.model = load_model(
            "arcface", params,
            compute_dtype or default_policy().compute_dtype, self.device,
            self.embed_precision)
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

    def _on_device(self, image):
        """An (H, W, 3) array or tensor as a tensor on the model's
        device."""
        if not isinstance(image, torch.Tensor):
            image = torch.from_numpy(np.ascontiguousarray(image))
        return image.to(self.device)

    def _warp(self, image, mats):
        """Aligned crops of one image, rounded as the reference's PIL warp
        rounds to uint8 (wrapper.py:63-71), on the device."""
        crops = warp_affine_batch(self._on_device(image), mats,
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
        faces (wrapper.py:109-184). Without ``faces_per_image``, each whole
        image is one face: one (N, 512) array for the N images."""
        if faces_per_image is None:
            # Resize+pad each whole image on the device and embed the
            # batch (reference wrapper.py:149-157 packs them as one
            # pseudo-image).
            if not len(images):
                return []  # the JAX package's result for no images
            with torch.inference_mode():
                crops = torch.stack([
                    preprocess_face_no_landmarks(
                        self._on_device(image), self.image_side)
                    for image in images
                ]).to(torch.float32)
            return self._embed(crops)
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
