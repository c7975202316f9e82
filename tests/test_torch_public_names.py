"""Every public name below the top level of the JAX package exists in the
port's twin module, or is a named exclusion with its reason.

A module's public names are its module-level functions, classes and
constants whose names do not start with ``_``, its ``__all__`` entries
and, in an ``__init__.py``, the names it imports from its own package.
Both sides are read with ``ast``, so that neither ``vis/cairo.py`` needs
pycairo; a last check imports every port module that imports on the CPU
and asks it with ``hasattr``.
"""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

import terran_tpu

REPO = Path(__file__).resolve().parents[1]

MODULES = ["terran_tpu"] + sorted(
    info.name
    for info in pkgutil.walk_packages(terran_tpu.__path__, "terran_tpu.")
)

_TPU_WARP = ("a stage of the windowed and grouped-slab warp ladder, a TPU "
             "cost reformulation bit-identical to the per-pixel warp "
             "(tests/test_warp.py::test_grouped_warp_bit_identical)")
_JAX_FORM = "the JAX form of a host function; the port's is its torch form"

# JAX name -> (the port's counterpart or None, reason).
EXCLUDED = {
    "terran_tpu.ops.fused_peaks.auto_plane_block": (
        None, "sizes the Pallas kernel's VMEM plane block; the CUDA "
        "kernels' tiles are fixed in csrc/fused_peaks.cu"),
    "terran_tpu.ops.pose_decode.limb_scores_matmul": (
        "terran_tpu_torch.ops.pose_decode.limb_scores",
        "the limb sampler as a one-hot matmul for the MXU, a TPU cost "
        "reformulation of limb_scores"),
    "terran_tpu.ops.resize.resize_bilinear": (
        "terran_tpu_torch.ops.resize.resize_bilinear_u8",
        "the bilinear resize as matmuls for the MXU, a TPU cost "
        "reformulation; the port resizes with F.interpolate"),
    "terran_tpu.ops.resize.resize_bilinear_u8_numpy": (
        "terran_tpu_torch.ops.resize.resize_bilinear_u8_host",
        "the 'host' plan's exact resize chain, one function in the port"),
    "terran_tpu.ops.resize.resize_bilinear_u8_torch": (
        "terran_tpu_torch.ops.resize.resize_bilinear_u8_host",
        "the 'host' plan's exact resize chain, one function in the port"),
    "terran_tpu.ops.warp.warp_affine_windowed": (
        "terran_tpu_torch.ops.warp.warp_affine_frames", _TPU_WARP),
    "terran_tpu.ops.warp.warp_affine_windowed_grouped": (
        "terran_tpu_torch.ops.warp.warp_affine_frames", _TPU_WARP),
    "terran_tpu.ops.warp.grouped_warp_eligible": (None, _TPU_WARP),
    "terran_tpu.ops.warp.best_warp_group": (None, _TPU_WARP),
    "terran_tpu.ops.warp.best_warp_config": (None, _TPU_WARP),
    "terran_tpu.ops.warp.WARP_CONFIGS": (None, _TPU_WARP),
    "terran_tpu.ops.warp.WARP_GROUPS": (None, _TPU_WARP),
    "terran_tpu.ops.warp.GROUP": (None, _TPU_WARP),
    "terran_tpu.ops.warp.GROUP_SLABS": (None, _TPU_WARP),
    "terran_tpu.ops.warp.SLAB_H": (None, _TPU_WARP),
    "terran_tpu.ops.warp.SLAB_W": (None, _TPU_WARP),
    "terran_tpu.ops.warp.SLAB_MARGIN": (None, _TPU_WARP),
    "terran_tpu.ops.warp.umeyama_jax": (
        "terran_tpu_torch.ops.warp.umeyama_torch", _JAX_FORM),
    "terran_tpu.ops.warp.alignment_matrices_jax": (
        "terran_tpu_torch.ops.warp.alignment_matrices_torch", _JAX_FORM),
    "terran_tpu.models.arcface.apply_int8": (
        "terran_tpu_torch.models.arcface.Int8FaceResNet100",
        "the int8 forward over a quantised flax tree; the port's is a "
        "module"),
    "terran_tpu.models.openpose.apply_int8": (
        "terran_tpu_torch.models.openpose.Int8BodyPoseModel",
        "the int8 forward over a quantised flax tree; the port's is a "
        "module"),
    "terran_tpu.models.quant.quantize_conv_kernels": (
        "terran_tpu_torch.models.quant.quantize_state_dict",
        "quantises a flax tree's HWIO kernels; the port quantises a state "
        "dict"),
    "terran_tpu.utils.convert.conv_kernel": (
        "terran_tpu_torch.utils.convert.conv_weight",
        "converts to flax's HWIO kernels; the port keeps torch's OIHW"),
    "terran_tpu.parallel.batch_sharding": (
        "terran_tpu_torch.parallel.ShardedBatch",
        "a GSPMD sharding; the port shards a batch by rank"),
    "terran_tpu.parallel.replicated_sharding": (
        "terran_tpu_torch.parallel.mesh.shard_params",
        "a GSPMD sharding; the port replicates by broadcast"),
    "terran_tpu.parallel.mesh.batch_sharding": (
        "terran_tpu_torch.parallel.mesh.ShardedBatch",
        "a GSPMD sharding; the port shards a batch by rank"),
    "terran_tpu.parallel.mesh.replicated_sharding": (
        "terran_tpu_torch.parallel.mesh.shard_params",
        "a GSPMD sharding; the port replicates by broadcast"),
    "terran_tpu.runtime.is_tpu": (
        None, "the port runs on CUDA cards, never on a TPU"),
    "terran_tpu.runtime.enable_compilation_cache": (
        None, "eager PyTorch compiles no programs, and the nvcc builds "
        "already cache in build/kernels/"),
    "terran_tpu.checkpoint.checkpoint_cmd": (
        "terran_tpu_torch.cli.main",
        "click's command group; the port's CLI is argparse's"),
    "terran_tpu.cli.cli": (
        "terran_tpu_torch.cli.main",
        "click's command group; the port's CLI is argparse's"),
}


def source(module):
    """The source file of a dotted module name in the checkout."""
    path = REPO.joinpath(*module.split("."))
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


def twin(module):
    return "terran_tpu_torch" + module[len("terran_tpu"):]


def statements(body):
    """Module-level statements, those under a top-level if/try/with
    included."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With, ast.ExceptHandler)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                yield from statements(getattr(node, field, []))


def assigned(node):
    targets = (node.targets if isinstance(node, ast.Assign)
               else [node.target] if isinstance(node, ast.AnnAssign) else [])
    return [t.id for t in targets if isinstance(t, ast.Name)]


def all_entries(tree):
    """``__all__``'s entries: a literal list or tuple, or ``list(D)`` of a
    literal dict ``D`` (the packages' lazy tables)."""
    dicts, out = {}, set()
    for node in statements(tree.body):
        for name in assigned(node):
            value = node.value
            if isinstance(value, ast.Dict):
                dicts[name] = {k.value for k in value.keys}
            if name != "__all__":
                continue
            if isinstance(value, (ast.List, ast.Tuple)):
                out |= {e.value for e in value.elts}
            else:
                out |= dicts[value.args[0].id]
    return out


def public_names(module):
    """The names the JAX module makes public."""
    path = source(module)
    tree = ast.parse(path.read_text())
    names = set(all_entries(tree))
    for node in statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        names.update(assigned(node))
        if (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
                and (node.level or node.module.split(".")[0]
                     == "terran_tpu")):
            names.update(a.asname or a.name for a in node.names)
    return {name for name in names if not name.startswith("_")}


def bound_names(module):
    """Every name the port module binds at module level, its lazy
    ``__all__`` entries included."""
    tree = ast.parse(source(module).read_text())
    names = set(all_entries(tree))
    for node in statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        names.update(assigned(node))
    return names


def expected(module):
    """The JAX module's public names that its twin must have."""
    return {name for name in public_names(module)
            if f"{module}.{name}" not in EXCLUDED}


def test_walk_finds_every_module():
    walked = {source(module) for module in MODULES}
    on_disk = set((REPO / "terran_tpu").rglob("*.py"))
    assert walked == on_disk


@pytest.mark.parametrize("module", MODULES)
def test_twin_has_every_public_name(module):
    assert source(twin(module)).exists(), f"{twin(module)} is missing"
    missing = expected(module) - bound_names(twin(module))
    assert not missing, f"{twin(module)} lacks {sorted(missing)}"


@pytest.mark.parametrize("name", sorted(EXCLUDED))
def test_exclusion_is_not_stale(name):
    """An excluded name is public in the JAX package and absent from the
    port, and its counterpart, if it names one, exists there."""
    module, attr = name.rsplit(".", 1)
    counterpart, reason = EXCLUDED[name]
    assert reason
    assert attr in public_names(module), f"{name} is not a public JAX name"
    assert attr not in bound_names(twin(module)), (
        f"{twin(module)} has {attr}: check it instead of excluding it")
    if counterpart is not None:
        other, other_attr = counterpart.rsplit(".", 1)
        assert other_attr in bound_names(other), f"{counterpart} is missing"


def test_port_modules_have_the_names():
    """hasattr over every port module that imports on the CPU; only the
    pycairo backend does not, for want of pycairo."""
    failed = {}
    for module in MODULES:
        try:
            port = importlib.import_module(twin(module))
        except ImportError as exc:
            failed[twin(module)] = exc.name
            continue
        missing = {name for name in expected(module)
                   if not hasattr(port, name)}
        assert not missing, f"{twin(module)} lacks {sorted(missing)}"
    assert failed == {"terran_tpu_torch.vis.cairo": "cairo"}


@pytest.mark.parametrize("package,module,names", [
    ("models", "retinaface", ["RetinaFace"]),
    ("models", "arcface", ["FaceResNet100"]),
    ("models", "openpose", ["BodyPoseModel"]),
    ("ops", "nms", ["nms_fixed", "iou_matrix"]),
])
def test_reexports_are_the_modules_objects(package, module, names):
    outer = importlib.import_module(f"terran_tpu_torch.{package}")
    inner = importlib.import_module(f"terran_tpu_torch.{package}.{module}")
    jax_outer = importlib.import_module(f"terran_tpu.{package}")
    for name in names:
        assert getattr(outer, name) is getattr(inner, name)
        assert hasattr(jax_outer, name)
