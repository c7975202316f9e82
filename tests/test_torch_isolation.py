"""The port runs without JAX, the JAX package or the host libraries that
the card's machine lacks, and never falls back to the CPU by itself."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCKED = ("jax", "jaxlib", "flax", "terran_tpu", "cv2", "PIL", "click",
           "requests")

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
    assert result.stdout.strip().splitlines()[-1].startswith("ok")


def test_sources_import_nothing_blocked():
    """No module of the package names a blocked module, lazy imports
    inside functions included."""
    import ast

    sources = sorted((REPO / "terran_tpu_torch").rglob("*.py"))
    assert sources
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, (path, name)
