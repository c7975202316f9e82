"""The port's examples (``examples/torch_*.py``) end to end on the CPU,
with a checkpoint store that the port's own ``convert`` filled and a fake
ffmpeg (``tests/test_examples.py`` for the JAX examples)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from torch_port_fixtures import (  # noqa: F401
    offline_registries, single_torch_thread,
)

sys.path.insert(0, str(Path(__file__).parent.parent / "examples"))

FRAMES, HEIGHT, WIDTH, BATCH = 6, 48, 64, 3


@pytest.fixture(scope="module")
def stocked_store(tmp_path_factory):
    """Random reference-format checkpoints of the three families, each
    converted into a fresh store by ``cli.main(['checkpoint', 'convert',
    ...])``."""
    from terran_tpu_torch import cli
    from torch_oracle import (
        random_arcface_state_dict, random_openpose_state_dict,
        random_retinaface_state_dict,
    )

    home = tmp_path_factory.mktemp("home")
    rng = np.random.default_rng(0)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("TERRAN_TPU_HOME", str(home))
        for cid, make in (("b5d77fff", random_retinaface_state_dict),
                          ("d206e4b0", random_arcface_state_dict),
                          ("11a769ad", random_openpose_state_dict)):
            pth = home / f"{cid}.pth"
            torch.save({k: torch.as_tensor(np.ascontiguousarray(v))
                        for k, v in make(rng).items()}, pth)
            assert cli.main(["checkpoint", "convert", cid, str(pth)]) == 0
            pth.unlink()
        yield home


@pytest.fixture
def store(stocked_store, monkeypatch, offline_registries):
    monkeypatch.setenv("TERRAN_TPU_HOME", str(stocked_store))


def test_match_example(store, tmp_path, rng, capsys):
    import torch_match

    ref_path = tmp_path / "ref.png"
    Image.fromarray(
        rng.integers(0, 255, (120, 120, 3), dtype=np.uint8)
    ).save(ref_path)
    img_dir = tmp_path / "gallery"
    img_dir.mkdir()
    for i in range(2):
        Image.fromarray(
            rng.integers(0, 255, (100, 140, 3), dtype=np.uint8)
        ).save(img_dir / f"g{i}.png")

    assert torch_match.main([str(ref_path), str(img_dir), "--threshold",
                             "2.0", "--batch-size", "2", "--device",
                             "cpu"]) == 0
    out = capsys.readouterr().out
    # Random weights either detect exactly one face in the reference image
    # (then the search runs and prints matches at the permissive threshold)
    # or not (then the script says so and ends): both are clean runs.
    if "exactly one face" not in out:
        lines = out.splitlines()
        assert lines[-1] == f"{len(lines) - 1} matching face(s) found."
        assert all(", confidence = " in line for line in lines[:-1])


def fake_ffmpeg(monkeypatch, tmp_path):
    """The reader emits FRAMES deterministic frames; the writer copies its
    input to ``sink.raw``. Returns (frames, sink path)."""
    probe = {
        "streams": [{"codec_type": "video", "width": WIDTH,
                     "height": HEIGHT, "avg_frame_rate": "3/1",
                     "duration": "2.0"}],
        "format": {"duration": "2.0"},
    }
    monkeypatch.setattr("terran_tpu_torch.io.video.reader.ffmpeg_probe",
                        lambda p, **kw: probe)
    size = WIDTH * HEIGHT * 3 * FRAMES
    emit = (
        "import sys\n"
        f"data = bytes(range(256)) * ({size} // 256 + 1)\n"
        f"sys.stdout.buffer.write(data[:{size}])\n"
    )
    monkeypatch.setattr(
        "terran_tpu_torch.io.video.reader.Video._prepare_ffmpeg_cmd",
        lambda self: [sys.executable, "-c", emit])
    sink = tmp_path / "sink.raw"
    copy = (
        "import sys, shutil\n"
        f"shutil.copyfileobj(sys.stdin.buffer, open(r'{sink}', 'wb'))\n"
    )
    monkeypatch.setattr(
        "terran_tpu_torch.io.video.writer.VideoWriter._prepare_ffmpeg_cmd",
        lambda self: [sys.executable, "-c", copy])
    frames = np.frombuffer((bytes(range(256)) * (size // 256 + 1))[:size],
                           np.uint8).reshape(FRAMES, HEIGHT, WIDTH, 3)
    return frames, sink


@pytest.mark.parametrize("engine,plan", [("task", None),
                                         ("pipeline", "device"),
                                         ("pipeline", "host")])
def test_video_example(engine, plan, store, tmp_path, monkeypatch):
    """Every frame is written, each equal to the port's own ``vis_faces``
    of that engine's detections (one colour for every face: faces without
    a label draw a random colour, in the writer thread)."""
    import torch_video
    from terran_tpu_torch import vis
    from terran_tpu_torch.face import Detection
    from terran_tpu_torch.pipeline import PerceptionPipeline

    monkeypatch.setattr(vis, "FACE_COLORMAP", lambda label=None: (255, 0, 0))
    frames, sink = fake_ffmpeg(monkeypatch, tmp_path)
    args = [str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4"),
            "--batch-size", str(BATCH), "--engine", engine, "--device",
            "cpu"]
    if plan is not None:
        args += ["--transfer-plan", plan]
    assert torch_video.main(args) == 0
    written = np.fromfile(sink, np.uint8)
    assert written.size == FRAMES * HEIGHT * WIDTH * 3
    written = written.reshape(FRAMES, HEIGHT, WIDTH, 3)

    if engine == "task":
        detect = Detection(threshold=0.5, device="cpu")
    else:
        pipeline = PerceptionPipeline(
            threshold=0.5, with_pose=False, with_embeddings=False,
            transfer_plan=plan, device="cpu")

        def detect(batch):
            return pipeline.faces_from(pipeline.process_batch(batch))
    drawn = 0
    for start in range(0, FRAMES, BATCH):
        batch = frames[start:start + BATCH]
        for i, (frame, faces) in enumerate(zip(batch, detect(batch))):
            expected = vis.vis_faces(frame, faces)
            assert np.array_equal(written[start + i], expected), start + i
            drawn += bool(faces)
    assert drawn


def test_streams_example_counts_every_frame(store, capsys):
    """Two synthetic 1080p streams of one frame each, one batch of 2,
    through the pipeline from the store with tracking (~30 s on one CPU
    thread, most of it FaceResNet100 on 16 crops)."""
    import torch_streams

    assert torch_streams.main(["--synthetic", "2", "--frames", "1",
                               "--batch-size", "2", "--device",
                               "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("2 frames over 2 streams in ")
    assert lines[0].endswith(" fps total")
    assert lines[1:] == ["  stream 0: 1 frames", "  stream 1: 1 frames"]


def test_streams_example_without_sources(capsys):
    import torch_streams

    assert torch_streams.main([]) == 0
    assert capsys.readouterr().out == "Give video paths or --synthetic N.\n"
