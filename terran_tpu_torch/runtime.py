"""Device and numerics policy.

``default_device`` is the first CUDA card, ``available_devices`` every
visible card and ``platform`` the string JAX gives an NVIDIA device,
``"gpu"``. There is no quiet CPU fallback: each raises when no card is
visible, and callers that want the CPU (the tests) say ``device="cpu"``.
``default_policy``/``set_default_policy`` hold the numerics policy that
the models read when they are given no ``compute_dtype``.
"""

import functools
import os
from dataclasses import dataclass

import torch


def _require_card():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )


def available_devices():
    """Every visible CUDA card, ``[cuda:0, cuda:1, ...]``; raises when
    there is none."""
    _require_card()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_device():
    """The default accelerator, ``cuda``; raises when no card is visible."""
    _require_card()
    return torch.device("cuda")


def platform():
    """The default device's platform string, ``"gpu"`` (JAX's name for an
    NVIDIA device); raises when no card is visible."""
    _require_card()
    return "gpu"


def resolve_device(device=None):
    """``device`` as a ``torch.device``, ``default_device()`` when None."""
    return default_device() if device is None else torch.device(device)


def check_precision(name, value):
    """``value`` of an ``embed_precision``/``pose_precision`` setting:
    'native' or 'int8' (the opt-in int8 trunk); any other value raises
    ``ValueError``."""
    if value not in ("native", "int8"):
        raise ValueError(f"{name} must be 'native' or 'int8', got {value!r}")
    return value


@functools.cache
def device_constant(values, dtype, device):
    """The nested tuple ``values`` as a ``dtype`` tensor on ``device``, made
    once per (values, dtype, device) and kept for the process: a CUDA graph
    captured over it reads it at its address. A copy from host memory to
    the card waits for everything queued on the stream, so ops that the
    pipeline enqueues ahead of the card take their constant tables from
    here."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


@dataclass(frozen=True)
class Policy:
    """Numerics policy for model execution, with the JAX package's fields
    in its order, so that positional construction means the same in both.

    ``param_dtype`` is the dtype weights are stored in. Nothing reads it,
    in either package: the models keep float32 parameters and the port
    converts weights in float32. ``compute_dtype`` is the dtype the
    convolutions run in.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def from_env():
        name = os.environ.get("TERRAN_TPU_COMPUTE_DTYPE", "bfloat16")
        dtype = getattr(torch, name, None)
        if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
            raise ValueError(f"TERRAN_TPU_COMPUTE_DTYPE={name!r} is not a "
                             "torch floating-point dtype")
        return Policy(compute_dtype=dtype)


_default_policy = None


def default_policy():
    global _default_policy
    if _default_policy is None:
        _default_policy = Policy.from_env()
    return _default_policy


def set_default_policy(policy):
    global _default_policy
    _default_policy = policy


def cast_params_for_compute(state_dict, compute_dtype, keep_f32=()):
    """Store float32 weights in the compute dtype once, at load time.

    ``keep_f32``: name prefixes whose weights stay float32 because their
    layer computes in float32, matched at the start of the key or after
    any '.' in it (a module's name at any depth, as the JAX package
    matches a path component). Non-float entries pass through.
    """
    if compute_dtype == torch.float32:
        return dict(state_dict)
    return {
        name: (
            value.to(compute_dtype)
            if value.dtype == torch.float32
            and not any(name.startswith(k) or f".{k}" in name
                        for k in keep_f32)
            else value
        )
        for name, value in state_dict.items()
    }


# Name prefixes that keep float32 storage per model family: ArcFace's
# 'embed' projection computes in float32; so do the ViT recognizer's
# position table, LayerNorms (norm1, norm2, norm) and head BatchNorms
# (bn1, bn2).
PARAMS_KEEP_F32 = {"arcface": ("embed",), "retinaface": (), "openpose": (),
                   "vit_l": ("pos_embed", "norm", "bn"), "body25": ()}


# ---------------------------------------------------------------------------
# Shape bucketing
# ---------------------------------------------------------------------------

def round_up(x, multiple):
    return -(-x // multiple) * multiple


def bucket_shape(h, w, mode="exact", multiple=64):
    """The (H, W) the detector runs at for an (h, w) input.

    - ``exact``: the input's own shape.
    - ``pad``: H and W rounded up to ``multiple``, so that mixed sizes
      share a few shapes; detections whose anchor cell lies in the padded
      margin are masked out.
    """
    if mode == "exact":
        return h, w
    if mode == "pad":
        return round_up(h, multiple), round_up(w, multiple)
    raise ValueError(f"unknown bucketing mode: {mode}")
