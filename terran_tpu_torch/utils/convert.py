"""Weight conversion into this package's state dicts.

Two sources:

- the reference's torch ``.pth`` state dicts (``convert_openpose``), whose
  OIHW conv weights this package keeps as they are;
- the converted store that ``terran_tpu`` writes (``<id>.npz``, a flattened
  JAX pytree with HWIO kernels), through :func:`params_from_jax`.

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


class Mapper:
    """Tracks consumed keys so full coverage can be asserted."""

    def __init__(self, state_dict):
        self.sd = dict(state_dict)
        self.used = set()

    def take(self, key):
        self.used.add(key)
        return self.sd[key]

    def conv_bias(self, prefix):
        """(weight OIHW, bias) of a biased conv, as float32 tensors."""
        return (
            _tensor(self.take(f"{prefix}.weight")),
            _tensor(self.take(f"{prefix}.bias")),
        )

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
    """JAX params pytree (``{layer: {"conv": {"kernel": HWIO, "bias"}}}``,
    numpy leaves) -> state dict with OIHW conv weights."""
    out = {}
    for name, layer in params.items():
        conv = layer["conv"]
        kernel = _np(conv["kernel"])
        if kernel.ndim != 4:
            raise ValueError(f"{name}: expected an HWIO conv kernel, got "
                             f"shape {kernel.shape}")
        out[f"{name}.weight"] = _tensor(np.transpose(kernel, (3, 2, 0, 1)))
        out[f"{name}.bias"] = _tensor(conv["bias"])
    return out


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


def load_params(path):
    with np.load(path) as data:
        return unflatten_tree({k: data[k] for k in data.files})
