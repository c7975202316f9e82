"""Weight conversion into this package's state dicts.

Two sources:

- the reference's torch ``.pth`` state dicts (``convert_retinaface``,
  ``convert_arcface``, ``convert_openpose``), whose OIHW conv weights this
  package keeps, with the folds of ``terran_tpu/utils/convert.py``:
  inference BatchNorm becomes a per-channel (scale, bias) affine, the
  RGB->BGR input flip goes into the first conv's input channels, and
  ArcFace's head BN1d goes into its linear layer;
- the converted store that both packages read and write (``<id>.npz``, a
  flattened JAX pytree with HWIO kernels), through :func:`params_from_jax`
  and its inverse :func:`params_to_jax`; :func:`convert_torch_checkpoint`
  writes a reference ``.pth`` into it as ``terran_tpu``'s converter does.

Conversion is strict: unmapped keys raise, so a registry or architecture
drift is caught at load time.
"""

import numpy as np
import torch


def _np(t):
    """Accept torch tensors or numpy arrays."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(_np(a)))


def conv_weight(w, flip_rgb=False):
    """An OIHW conv weight as a float32 tensor; ``flip_rgb`` reverses the
    input channels, so a network fed BGR takes RGB."""
    w = _np(w)
    if flip_rgb:
        w = w[:, ::-1, :, :]
    return _tensor(w)


def bn_affine(sd, prefix, eps):
    """Inference BatchNorm as (scale, bias): ``scale = gamma /
    sqrt(var + eps)``, ``bias = beta - mean * scale`` (float32 numpy)."""
    gamma = _np(sd[f"{prefix}.weight"])
    beta = _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    return scale, bias


def flatten_state(tree, prefix=""):
    """Nested dict -> state dict with '.'-joined keys."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(flatten_state(value, path))
        else:
            flat[path] = value
    return flat


class Mapper:
    """Tracks consumed keys so full coverage can be asserted."""

    def __init__(self, state_dict):
        self.sd = dict(state_dict)
        self.used = set()

    def take(self, key):
        self.used.add(key)
        return self.sd[key]

    def _use_bn(self, bn_prefix):
        for suffix in ("weight", "bias", "running_mean", "running_var",
                       "num_batches_tracked"):
            self.used.add(f"{bn_prefix}.{suffix}")

    def conv_bias(self, prefix, flip_rgb=False):
        """(weight OIHW, bias) of a biased conv, as float32 tensors."""
        return (
            conv_weight(self.take(f"{prefix}.weight"), flip_rgb),
            _tensor(self.take(f"{prefix}.bias")),
        )

    def conv_affine(self, conv_prefix, bn_prefix, eps, flip_rgb=False):
        """A conv followed by a BN, as a :class:`ConvAffine`'s parameters.
        A conv bias feeding the BN (the reference's FPN and context convs
        keep torch's default bias=True) folds through the affine:
        BN(Wx + b) = scale * Wx + (scale * b + bias)."""
        weight = conv_weight(self.take(f"{conv_prefix}.weight"), flip_rgb)
        self._use_bn(bn_prefix)
        scale, bias = bn_affine(self.sd, bn_prefix, eps)
        conv_bias_key = f"{conv_prefix}.bias"
        if conv_bias_key in self.sd:
            bias = bias + scale * _np(self.take(conv_bias_key))
        return {"conv": {"weight": weight}, "scale": _tensor(scale),
                "bias": _tensor(bias)}

    def affine(self, bn_prefix, eps):
        """A standalone BN as an :class:`Affine`'s parameters."""
        self._use_bn(bn_prefix)
        scale, bias = bn_affine(self.sd, bn_prefix, eps)
        return {"scale": _tensor(scale), "bias": _tensor(bias)}

    def prelu(self, prefix):
        return _tensor(self.take(f"{prefix}.weight"))

    def assert_consumed(self):
        remaining = [
            k for k in self.sd
            if k not in self.used and not k.endswith("num_batches_tracked")
        ]
        if remaining:
            raise ValueError(
                f"unconverted checkpoint keys ({len(remaining)}): "
                f"{sorted(remaining)[:8]}..."
            )


# ---------------------------------------------------------------------------
# RetinaFace (reference module paths from retinaface/model.py)
# ---------------------------------------------------------------------------

def convert_retinaface(state_dict):
    """Reference RetinaFace ``.pth`` state dict -> :class:`RetinaFace`
    state dict (the layout of ``terran_tpu``'s ``convert_retinaface``)."""
    m = Mapper(state_dict)
    eps_base, eps_fpn = 1e-5, 2e-5  # model.py:28 vs model.py:128,180

    def sep_block(torch_prefix):
        return {
            "conv_block": m.conv_affine(f"{torch_prefix}.conv_block.0",
                                        f"{torch_prefix}.conv_block.1",
                                        eps_base),
            "sep_block": m.conv_affine(f"{torch_prefix}.sep_block.0",
                                       f"{torch_prefix}.sep_block.1",
                                       eps_base),
        }

    base = {
        "first_conv": m.conv_affine("base.first_conv_block.0",
                                    "base.first_conv_block.1", eps_base,
                                    flip_rgb=True),
        "first_sep": m.conv_affine("base.first_conv_block.3",
                                   "base.first_conv_block.4", eps_base),
    }
    for i in range(5):
        base[f"s0_b{i}"] = sep_block(f"base.scales.0.{i}")
    for i in range(6):
        base[f"s1_b{i}"] = sep_block(f"base.scales.1.{i}")
    base["final_b0"] = sep_block("base.final_conv.0")
    base["final_conv"] = m.conv_affine("base.final_conv.1",
                                       "base.final_conv.2", eps_base)

    def fpn(name):
        return m.conv_affine(f"{name}.0", f"{name}.1", eps_fpn)

    def context(p):
        return {
            "ctx3": fpn(f"{p}.context_3x3"),
            "reducer": fpn(f"{p}.dimension_reducer"),
            "ctx5": fpn(f"{p}.context_5x5"),
            "ctx7a": fpn(f"{p}.context_7x7"),
            "ctx7b": m.conv_affine(f"{p}.context_7x7.3", f"{p}.context_7x7.4",
                                   eps_fpn),
        }

    refiner = {
        "conv_s8": fpn("refiner.conv_stride8"),
        "conv_s16": fpn("refiner.conv_stride16"),
        "conv_s32": fpn("refiner.conv_stride32"),
        "aggr_s8": fpn("refiner.aggr_stride8"),
        "aggr_s16": fpn("refiner.aggr_stride16"),
        "ctx_s8": context("refiner.context_stride8"),
        "ctx_s16": context("refiner.context_stride16"),
        "ctx_s32": context("refiner.context_stride32"),
    }

    heads = {}
    for stride in (8, 16, 32):
        for head in ("cls", "bbox", "landmark"):
            weight, bias = m.conv_bias(f"outputs.{head}_stride{stride}")
            heads[f"{head}_s{stride}"] = {"weight": weight, "bias": bias}

    m.assert_consumed()
    return flatten_state({"base": base, "refiner": refiner, "heads": heads})


# ---------------------------------------------------------------------------
# ArcFace FaceResNet100 (reference module paths from arcface/model.py)
# ---------------------------------------------------------------------------

ARCFACE_UNITS_PER_STAGE = (3, 13, 30, 3)  # arcface/model.py:44


def convert_arcface(state_dict):
    """Reference ArcFace ``.pth`` state dict -> :class:`FaceResNet100`
    state dict. The head's BN1d folds into the linear layer, whose input
    features are permuted from torch's (C, h, w) flatten order to the
    (h, w, C) order in which the model flattens (as the JAX model does)."""
    m = Mapper(state_dict)
    eps = 2e-5

    params = {
        "initial": m.conv_affine("initial_layer.0", "initial_layer.1", eps,
                                 flip_rgb=True),
        "initial_prelu": m.prelu("initial_layer.2"),
    }
    for stage_idx, num_units in enumerate(ARCFACE_UNITS_PER_STAGE):
        for unit_idx in range(num_units):
            p = f"stages.{stage_idx}.{unit_idx}"
            unit = {
                "pre": m.affine(f"{p}.body.0", eps),
                "conv1": m.conv_affine(f"{p}.body.1", f"{p}.body.2", eps),
                "prelu": m.prelu(f"{p}.body.3"),
                "conv2": m.conv_affine(f"{p}.body.4", f"{p}.body.5", eps),
            }
            if unit_idx == 0:  # the stride-2 unit has a projection shortcut
                unit["shortcut"] = m.conv_affine(f"{p}.shortcut.0",
                                                 f"{p}.shortcut.1", eps)
            params[f"stage{stage_idx}_unit{unit_idx}"] = unit

    # Head: BN2d -> (Dropout) -> Flatten -> Linear -> BN1d
    # (arcface/model.py:79-85).
    params["head_pre"] = m.affine("final_layer.0", eps)
    w = _np(m.take("final_layer.3.weight"))  # (512, 512 * 7 * 7)
    b = _np(m.take("final_layer.3.bias"))
    m._use_bn("final_layer.4")
    scale, bias = bn_affine(m.sd, "final_layer.4", eps)
    w = w.reshape(512, 512, 7, 7).transpose(0, 2, 3, 1).reshape(512, -1)
    # The JAX converter folds as (w * scale[:, None]).T, then stores it
    # transposed; the same float32 products here.
    params["embed"] = {"weight": _tensor(w * scale[:, None]),
                       "bias": _tensor(b * scale + bias)}

    m.assert_consumed()
    return flatten_state(params)


# ---------------------------------------------------------------------------
# OpenPose body model (reference module paths from openpose/model.py)
# ---------------------------------------------------------------------------

OPENPOSE_BLOCK0 = (
    "conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
    "conv3_3", "conv3_4", "conv4_1", "conv4_2", "conv4_3_CPM", "conv4_4_CPM",
)


def openpose_layer_sources():
    """(layer name, reference state-dict prefix) for every OpenPose conv,
    in forward order."""
    layers = [(name, f"model0.{name}") for name in OPENPOSE_BLOCK0]
    for branch in (1, 2):
        for i in range(1, 6):
            name = f"conv5_{i}_CPM_L{branch}"
            layers.append((name, f"model1_{branch}.{name}"))
    for stage in range(2, 7):
        for branch in (1, 2):
            for i in range(1, 8):
                name = f"Mconv{i}_stage{stage}_L{branch}"
                layers.append((name, f"model{stage}_{branch}.{name}"))
    return layers


def convert_openpose(state_dict):
    """Reference OpenPose ``.pth`` state dict -> :class:`BodyPoseModel`
    state dict (``<layer>.weight`` OIHW, ``<layer>.bias``). The model takes
    RGB like the reference (openpose/wrapper.py:116-122), so no channel
    flip."""
    m = Mapper(state_dict)
    out = {}
    for name, prefix in openpose_layer_sources():
        out[f"{name}.weight"], out[f"{name}.bias"] = m.conv_bias(prefix)
    m.assert_consumed()
    return out


def params_from_jax(params):
    """A ``terran_tpu`` params pytree (numpy leaves) -> this package's
    state dict, for every model family:

    - ``kernel`` leaves become ``weight``: HWIO conv kernels OIHW (a
      depthwise ``(kh, kw, 1, C)`` kernel becomes ``(C, 1, kh, kw)``),
      ``(I, O)`` Dense kernels ``(O, I)``;
    - the ``conv`` level of a conv with a bias (``ConvBias``, OpenPose) is
      dropped, since this package's ``ConvBias`` is the conv itself; a
      ``ConvAffine``'s bias-free ``conv`` level stays;
    - a quantised conv's ``kernel_q`` (int8 HWIO) and ``kernel_scale``
      (the JAX package's ``quantize_params``) become ``weight_q`` (int8
      OIHW) and ``weight_scale``, the int8 models' buffers;
    - every other leaf (affine scales and biases, PReLU alphas) carries
      over under its path, as float32.
    """
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            path = f"{prefix}.{key}" if prefix else key
            if isinstance(value, dict):
                if key == "conv" and "bias" in value:
                    path = prefix
                walk(value, path)
            elif key == "kernel_q":
                kernel = np.transpose(np.asarray(value, np.int8),
                                      (3, 2, 0, 1))
                out[f"{prefix}.weight_q"] = torch.from_numpy(
                    np.ascontiguousarray(kernel))
            elif key == "kernel_scale":
                out[f"{prefix}.weight_scale"] = _tensor(value)
            elif key == "kernel":
                kernel = _np(value)
                if kernel.ndim == 4:
                    kernel = np.transpose(kernel, (3, 2, 0, 1))
                elif kernel.ndim == 2:
                    kernel = kernel.T
                else:
                    raise ValueError(f"{path}: unexpected kernel shape "
                                     f"{kernel.shape}")
                out[f"{prefix}.weight" if prefix else "weight"] = _tensor(
                    kernel)
            else:
                out[path] = _tensor(value)

    walk(params, "")
    return out


# Families whose biased convs are ``ConvBias`` modules in the JAX models,
# which nest their ``nn.Conv`` as ``conv`` (RetinaFace's heads are bare
# ``nn.Conv`` layers).
CONV_BIAS_FAMILIES = ("openpose",)


def params_to_jax(state_dict, model_key):
    """This package's state dict -> the ``terran_tpu`` params pytree of the
    ``model_key`` family (numpy float32 leaves), the inverse of
    :func:`params_from_jax`:

    - ``weight`` leaves become ``kernel``: OIHW conv weights HWIO (a
      depthwise ``(C, 1, kh, kw)`` weight ``(kh, kw, 1, C)``), ``(O, I)``
      Dense weights ``(I, O)``;
    - a ``ConvBias`` (OpenPose's convs) gets its ``conv`` level back;
    - the '.'-joined keys become nested dicts.

    The transposes are views of the arrays, as the JAX converters return
    them, so :func:`save_params` writes the bytes that they write.
    """
    if model_key not in CONVERTERS:
        raise ValueError(f"unknown model family {model_key!r}")
    tree = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        array = _np(value)
        if leaf == "weight":
            if array.ndim == 4:
                array = np.transpose(array, (2, 3, 1, 0))
            elif array.ndim == 2:
                array = array.T
            else:
                raise ValueError(f"{key}: unexpected weight shape "
                                 f"{array.shape}")
            leaf = "kernel"
        if model_key in CONV_BIAS_FAMILIES and leaf in ("kernel", "bias"):
            path.append("conv")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = array
    return tree


def as_state_dict(params):
    """This package's state dict from either form a caller holds: a state
    dict ('.'-joined keys) passes through; a ``terran_tpu`` params pytree
    (nested dicts, as ``terran_tpu.pipeline.PerceptionPipeline`` takes
    them) goes through :func:`params_from_jax`."""
    if any(isinstance(value, dict) for value in params.values()):
        return params_from_jax(params)
    return params


# ---------------------------------------------------------------------------
# The converted store: flat .npz with '/'-joined keys
# ---------------------------------------------------------------------------

def flatten_tree(tree, prefix=""):
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat):
    tree = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_params(path, params):
    np.savez(path, **flatten_tree(params))


def load_params(path):
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})


CONVERTERS = {
    "retinaface": convert_retinaface,
    "arcface": convert_arcface,
    "openpose": convert_openpose,
}


def convert_torch_checkpoint(model_key, pth_path, out_path):
    """Convert a reference ``.pth`` file into the store's ``.npz`` format
    (the JAX package's pytree: HWIO kernels, '/'-joined keys), so that both
    packages read the file. Returns this package's state dict."""
    state_dict = torch.load(pth_path, map_location="cpu", weights_only=True)
    converted = CONVERTERS[model_key](state_dict)
    save_params(out_path, params_to_jax(converted, model_key))
    return converted
