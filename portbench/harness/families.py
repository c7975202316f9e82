"""A configuration's model families, found by name.

Each key of a configuration's ``"models"`` block names a family, whose
binding is ``families/<name>.py``. A binding gives:

- ``ROLE``: ``"detector"``, ``"recognizer"`` or ``"pose"``;
- ``specs()``: the (key, shape, init) table of its published checkpoint,
  from which ``harness/weights.py`` draws;
- ``forward(sd, x, ops)`` on (N, 3, H, W) float32 input, for the
  operation count, and ``input_size(height, width, cfg)``: the (h, w) of
  the one input the count uses, a frame's resize under the pipeline
  settings ``cfg`` or a face's crop;
- the reference functions of its role: a detector's
  ``detect(sd, frames, short_side, ops)`` and ``anchors(h, w)``, a
  recognizer's ``embed(sd, frame, landmarks, ops)`` and ``EMBED_DIM``, a
  pose model's ``heatmaps(sd, frames, short_side, ops)`` and ``PARTS``;
- ``pipeline_kwargs(sd)``: the ``PerceptionPipeline`` keywords that hand
  the program its converted weights, importing the program inside.

The reference math lives under ``reference/``; a binding only points at
it. A configuration names at most one family of each role, and a
detector."""

import importlib.util
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parents[1]
# In the order the operation count sums them.
ROLES = ("detector", "pose", "recognizer")
# The pipeline's switch of each role that it can run without.
SWITCHES = {"recognizer": "with_embeddings", "pose": "with_pose"}
# The pipeline setting that picks each role's precision, and so the peak
# rate its operations are held to; a role without one runs bf16.
PRECISION = {"recognizer": "embed_precision", "pose": "pose_precision"}

_loaded = {}


class Family(NamedTuple):
    name: str
    binding: object


def path(name, bench=None):
    return Path(bench or BENCH) / "families" / f"{name}.py"


def binding(name, bench=None):
    """The module ``families/<name>.py``, loaded once per file."""
    file = path(name, bench).resolve()
    if file not in _loaded:
        spec = importlib.util.spec_from_file_location(
            f"portbench_family_{name}", file)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[file] = module
    return _loaded[file]


def of(config, bench=None):
    """{role: Family} of the configuration's ``"models"`` block, in
    ``ROLES`` order. Raises ``ValueError`` naming the first fault: a
    family without a binding file, an unknown role, two families of one
    role, or no detector."""
    found = {}
    for name in config["models"]:
        if not path(name, bench).is_file():
            raise ValueError(f"family {name}: no binding families/{name}.py")
        module = binding(name, bench)
        role = getattr(module, "ROLE", None)
        if role not in ROLES:
            raise ValueError(f"family {name}: unknown role {role!r}")
        if role in found:
            raise ValueError(f"families {found[role].name} and {name} are "
                             f"both a {role}")
        found[role] = Family(name, module)
    if "detector" not in found:
        raise ValueError(f"no detector among the families "
                         f"{sorted(config['models'])}")
    return {role: found[role] for role in ROLES if role in found}
