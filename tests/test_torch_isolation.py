"""The port runs without JAX, the JAX package or the host libraries that
the card's machine lacks, and never falls back to the CPU by itself."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCKED = ("jax", "jaxlib", "flax", "terran_tpu", "cv2", "PIL", "click",
           "requests", "cairo", "matplotlib")

SCRIPT = textwrap.dedent(f"""
    import importlib.abc
    import sys

    BLOCKED = {BLOCKED!r}

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Blocker())

    import numpy as np
    import torch

    torch.cuda.is_available = lambda: False
    import terran_tpu_torch
    from terran_tpu_torch.face.detection import RetinaFaceDetector
    from terran_tpu_torch.face.recognition import ArcFaceRecognizer
    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.pose.openpose import OpenPoseEstimator
    from terran_tpu_torch.utils.convert import (
        convert_arcface, convert_openpose, convert_retinaface,
    )
    from torch_oracle import (
        random_arcface_state_dict, random_openpose_state_dict,
        random_retinaface_state_dict,
    )

    try:
        terran_tpu_torch.default_device()
    except RuntimeError as exc:
        print("default_device raised:", exc)
    else:
        raise SystemExit("default_device() returned without a card")
    for cls in (OpenPoseEstimator, RetinaFaceDetector, ArcFaceRecognizer):
        try:
            cls(params={{}})
        except RuntimeError as exc:
            assert "no CUDA device" in str(exc), exc
        else:
            raise SystemExit(f"{{cls.__name__}} picked a device without a "
                             "card")

    sd = random_openpose_state_dict(np.random.default_rng(0))
    est = OpenPoseEstimator(params=convert_openpose(sd), device="cpu",
                            short_side=48, max_peaks=8)
    images = np.random.default_rng(1).integers(
        0, 255, (1, 48, 64, 3), dtype=np.uint8)
    out = est.call(images)
    assert len(out) == 1

    rng = np.random.default_rng(2)
    det = RetinaFaceDetector(params=convert_retinaface(
        random_retinaface_state_dict(rng)), device="cpu", top_k=16)
    faces = det.call(images)
    assert len(faces) == 1 and faces[0], faces
    rec = ArcFaceRecognizer(params=convert_arcface(
        random_arcface_state_dict(rng)), device="cpu")
    feats = rec.call(list(images), [faces[0][:1]])
    assert feats[0].shape == (1, 512), feats[0].shape

    try:
        PerceptionPipeline(det_params={{}}, rec_params={{}}, pose_params={{}})
    except RuntimeError as exc:
        assert "no CUDA device" in str(exc), exc
    else:
        raise SystemExit("PerceptionPipeline picked a device without a card")
    pipe = PerceptionPipeline(
        det_params=convert_retinaface(random_retinaface_state_dict(rng)),
        rec_params=convert_arcface(random_arcface_state_dict(rng)),
        pose_params=convert_openpose(sd), device="cpu", det_short_side=48,
        pose_short_side=48, top_k=8, max_faces=1, max_peaks=4,
        max_escalations=0)
    result = pipe.process_batch(images)
    assert result["boxes"].shape == (1, 8, 4), result["boxes"].shape
    assert result["embeddings"].shape == (1, 1, 512)
    assert len(result["poses"]) == 1
    # The 'host' plan under 'auto' falls through to the exact chain when
    # cv2 does not import; at the identity resize it is the device plan.
    with PerceptionPipeline(
            det_params=pipe.det_params, rec_params=pipe.rec_params,
            pose_params=pipe.pose_params, device="cpu", det_short_side=48,
            pose_short_side=48, top_k=8, max_faces=1, max_peaks=4,
            max_escalations=0, transfer_plan="host",
            host_resize="auto") as host:
        assert not host._uses_cv2()
        result_host = host.process_batch(images)
    for key in ("boxes", "mask", "embeddings", "embeddings_mask"):
        assert np.array_equal(result_host[key], result[key]), key
    print("host plan:", int(result_host["mask"].sum()), "faces")

    # The host layers: tracking (scipy is allowed), video sources, the
    # multiplexer, tiled detection and recognition without landmarks.
    from terran_tpu_torch.io.streams import StreamMultiplexer
    from terran_tpu_torch.io.video import SyntheticVideo
    from terran_tpu_torch.ops.tiling import TiledDetector
    from terran_tpu_torch.tracking import Sort
    import terran_tpu_torch.io.video.parallel
    import terran_tpu_torch.io.video.writer

    tracked = Sort(min_hits=0).update(faces[0][:2])
    assert len(tracked) == len(faces[0][:2]), tracked
    mux = StreamMultiplexer([SyntheticVideo(32, 16, 3, seed=0),
                             SyntheticVideo(32, 16, 2, seed=1)],
                            batch_size=4)
    metas = [meta for _, meta in mux]
    assert metas == [[(0, 0), (1, 0), (0, 1), (1, 1)], [(0, 2)]], metas
    tiled = TiledDetector(det, tile=64, overlap=16)(images[0, :48, :64])
    assert tiled and all(f["landmarks"].shape == (5, 2) for f in tiled)
    whole = rec.call([images[0], images[0][:20, :40]])
    assert whole.shape == (2, 512), whole.shape

    # Scale-out over torch.distributed: a CPU world of one.
    import torch.distributed as dist
    from terran_tpu_torch.ops.nms import make_sharded_nms
    from terran_tpu_torch.parallel import (
        SpatialShardedDetector, create_mesh,
    )

    mesh = create_mesh(devices="cpu")
    spatial = SpatialShardedDetector(det, mesh=mesh, halo=32, top_k=16)(
        images[0])
    assert spatial and all(f["bbox"].shape == (4,) for f in spatial)
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0], [1.0, 1.0, 11.0, 11.0]])
    kept = make_sharded_nms(mesh, local_top_k=2, top_k=2)(
        boxes, torch.tensor([0.9, 0.8]))[2]
    assert kept.tolist() == [True, False], kept
    dist.destroy_process_group()

    # The leaf group imports without Pillow, pycairo or matplotlib; the
    # checkpoint commands run; drawing and image loading raise.
    import terran_tpu_torch.io.image
    import terran_tpu_torch.vis
    from terran_tpu_torch import cli

    assert cli.main(["checkpoint", "list"]) == 0
    for call in (lambda: terran_tpu_torch.vis_faces(images[0], []),
                 lambda: terran_tpu_torch.vis_poses(images[0], []),
                 lambda: terran_tpu_torch.open_image("x.png")):
        try:
            call()
        except ImportError as exc:
            print("leaf raised:", exc)
        else:
            raise SystemExit("a leaf function ran without its library")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("ok", len(out[0]))
""")


def test_port_runs_without_jax_or_host_libraries():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(REPO / "tests"), env.get("PYTHONPATH", "")]
    )
    env["TERRAN_TPU_COMPUTE_DTYPE"] = "float32"
    result = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    assert "default_device raised" in result.stdout
    assert "RetinaFace (b5d77fff)" in result.stdout
    assert result.stdout.count("leaf raised:") == 3
    assert "need Pillow or pycairo" in result.stdout
    assert result.stdout.strip().splitlines()[-1].startswith("ok")


# The only imports of a blocked module in the package, each where it is
# allowed: (path, enclosing function or None for module level, module).
# cv2 in the 'host' plan's OpenCV forms; Pillow, pycairo and matplotlib in
# the leaf group's image loading and drawing.
ALLOWED = {
    ("terran_tpu_torch/ops/resize.py", "resize_bilinear_u8_cv2", "cv2"),
    ("terran_tpu_torch/ops/warp.py", "warp_affine_u8_batch_cv2", "cv2"),
    ("terran_tpu_torch/io/image.py", "open_image", "PIL"),
    ("terran_tpu_torch/io/image.py", "resolve_images", "PIL"),
    ("terran_tpu_torch/vis/__init__.py", "display_image", "PIL"),
    ("terran_tpu_torch/vis/__init__.py", "display_image", "matplotlib"),
    ("terran_tpu_torch/vis/pillow.py", None, "PIL"),
    ("terran_tpu_torch/vis/cairo.py", None, "cairo"),
}


def imports(node, function=None):
    """(enclosing function or None, module) of every import under
    ``node``."""
    import ast

    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.Import):
            for alias in child.names:
                yield function, alias.name
        elif isinstance(child, ast.ImportFrom):
            yield function, child.module or ""
        inner = (child.name if isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef)) else function)
        yield from imports(child, inner)


def test_sources_import_nothing_blocked():
    """No module of the package names a blocked module, lazy imports
    inside functions included, except at the places ALLOWED lists, each
    of which is used."""
    import ast

    sources = sorted((REPO / "terran_tpu_torch").rglob("*.py"))
    assert sources
    used = set()
    for path in sources:
        rel = path.relative_to(REPO).as_posix()
        for function, name in imports(ast.parse(path.read_text())):
            place = (rel, function, name.split(".")[0])
            if place in ALLOWED:
                used.add(place)
                continue
            assert name.split(".")[0] not in BLOCKED, (rel, function, name)
    assert used == ALLOWED


def test_public_names_equal_the_jax_packages():
    import terran_tpu
    import terran_tpu_torch

    for name in terran_tpu_torch.__all__:
        assert getattr(terran_tpu_torch, name) is not None, name
    assert set(terran_tpu_torch.__all__) == set(terran_tpu.__all__)
