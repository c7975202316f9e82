"""The port's concurrent-stream perception (``terran_tpu_torch.io.streams``),
float32 on the CPU.

The multiplexer's batches and metas equal the JAX multiplexer's on the
same synthetic streams. ``MultiStreamPerception`` with tracking is held
to the JAX class on the tiny pipeline of ``tests/test_torch_pipeline_host.py``
(weights from ``default_rng(33)``, top_k 16, max_faces 4, max_peaks 8, no
escalation, pose thresholds lowered so that random weights assemble
humans) with 128x192 frames at det short side 64 and pose 32, where both
packages' resizes agree bit for bit (x1/2, x1/4): faces equal, poses
equal, embeddings within 2e-4 (the two FaceResNet100 forwards sum in
other orders) and track ids equal relative to each package's counter at
the start. Each package reads its own ``SyntheticVideo``: the
multiplexer catches its own package's ``EndOfVideo``.
"""

import random
import threading
import time

import numpy as np
import pytest

from terran_tpu.io import streams as jax_streams
from terran_tpu.io.video import EndOfVideo as JaxEndOfVideo
from terran_tpu.io.video import SyntheticVideo as JaxSyntheticVideo
from terran_tpu.pipeline import PerceptionPipeline as JaxPipeline
from terran_tpu.tracking.face import KalmanTracker as JaxKalmanTracker
from terran_tpu.utils.convert import convert_arcface as jax_convert_arcface
from terran_tpu.utils.convert import convert_openpose as jax_convert_openpose
from terran_tpu.utils.convert import (
    convert_retinaface as jax_convert_retinaface,
)
from terran_tpu_torch.io import streams as port_streams
from terran_tpu_torch.io.streams import (
    MultiStreamPerception, StreamMultiplexer,
)
from terran_tpu_torch.io.video import EndOfVideo, SyntheticVideo
from terran_tpu_torch.io.video.prefetch import threaded_device_put
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.tracking.face import KalmanTracker
from torch_oracle import (
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict,
)
from torch_port_fixtures import (  # noqa: F401
    single_torch_thread, single_torch_thread_module,
)

TINY = {"top_k": 16, "max_faces": 4, "max_peaks": 8, "max_escalations": 0,
        "det_short_side": 64, "pose_short_side": 32}
LOWERED_POSE_THRESHOLDS = {"keypoint_threshold": -1e9,
                           "thresh_midpoint": -1e9, "human_threshold": -1e9}


def make_streams(cls, counts, w=16, h=8, batch=3, pattern="gradient"):
    return [cls(width=w, height=h, num_frames=n, batch_size=batch, seed=i,
                pattern=pattern)
            for i, n in enumerate(counts)]


@pytest.mark.parametrize("counts,batch_size,source_batch", [
    ([5, 3, 4], 4, 3), ([4, 4], 4, 3), ([4, 4], 3, None), ([7, 1, 2], 5, 2),
    ([2], 4, None), ([], 4, 3)])
def test_multiplexer_matches_jax(counts, batch_size, source_batch):
    got = list(StreamMultiplexer(
        make_streams(SyntheticVideo, counts, batch=source_batch),
        batch_size=batch_size))
    exp = list(jax_streams.StreamMultiplexer(
        make_streams(JaxSyntheticVideo, counts, batch=source_batch),
        batch_size=batch_size))
    assert len(got) == len(exp)
    for (frames, meta), (jax_frames, jax_meta) in zip(got, exp):
        assert meta == jax_meta
        assert frames.dtype == jax_frames.dtype
        np.testing.assert_array_equal(frames, jax_frames)
    seen = [pair for _, meta in got for pair in meta]
    assert len(seen) == len(set(seen)) == sum(counts)
    for stream, count in enumerate(counts):
        assert sorted(f for s, f in seen if s == stream) == list(range(count))


def test_multiplexer_interleaves_and_flushes():
    batches = list(StreamMultiplexer(
        make_streams(SyntheticVideo, [5, 3, 4]), batch_size=4))
    assert [s for s, _ in batches[0][1]] == [0, 1, 2, 0]
    assert [len(meta) for _, meta in batches] == [4, 4, 4]
    assert all(frames.shape[1:] == (8, 16, 3) for frames, _ in batches)


def test_multiplexer_stops_on_this_packages_end_of_video():
    """A source raising the JAX package's EndOfVideo is not this package's
    end of stream: it propagates."""
    with pytest.raises(JaxEndOfVideo):
        list(StreamMultiplexer([JaxSyntheticVideo(num_frames=0)]))
    assert not issubclass(JaxEndOfVideo, EndOfVideo)
    assert list(StreamMultiplexer([SyntheticVideo(num_frames=0)])) == []


class ThreadedFakePipeline:
    """A stand-in pipeline whose ``process_stream`` pulls the batch
    generator on a worker thread, as the real one's uploader does, with
    jittered timing; each frame's one face encodes the frame's content."""

    def process_stream(self, batches):
        rng = random.Random(0)

        def put(frames):
            time.sleep(rng.uniform(0, 0.004))
            return frames

        for frames in threaded_device_put(batches, depth=2, put=put):
            time.sleep(rng.uniform(0, 0.004))
            yield {"frames": frames}

    @staticmethod
    def faces_from(out):
        return [[{"bbox": np.array([0, 0, 10, 10], np.int32),
                  "landmarks": np.zeros((5, 2), np.int32),
                  "score": np.float32(frame.mean())}]
                for frame in out["frames"]]


def test_meta_fifo_pairs_results_under_an_upload_thread():
    """Results keep their (stream, frame) through the meta FIFO while the
    generator is pulled ahead on another thread, the final partial batch
    padded and its padding dropped."""
    counts = [9, 4, 7]
    streams = make_streams(SyntheticVideo, counts, batch=2, pattern="noise")
    expected = {}
    for s, video in enumerate(make_streams(SyntheticVideo, counts,
                                           batch=None, pattern="noise")):
        for f, frame in enumerate(video):
            expected[(s, f)] = np.float32(frame.mean())
    msp = MultiStreamPerception(ThreadedFakePipeline(), streams,
                                batch_size=3, track=False)
    before = threading.active_count()
    results = [r for batch in msp for r in batch]
    assert len(results) == sum(counts)
    assert {(r["stream"], r["frame"]) for r in results} == set(expected)
    for r in results:
        assert r["faces"][0]["score"] == expected[(r["stream"], r["frame"])]
        assert r["embeddings"] is None and r["pose"] is None
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_trackers_follow_each_streams_framerate():
    streams = [SyntheticVideo(num_frames=1, framerate=60),
               SyntheticVideo(num_frames=1, framerate=25)]
    msp = MultiStreamPerception(None, streams, track=True)
    assert [(t.max_age, t.min_hits) for t in msp.trackers] == [(60, 12),
                                                                (25, 5)]
    msp = MultiStreamPerception(None, iter(streams), min_hits=1, max_age=3)
    assert [(t.max_age, t.min_hits) for t in msp.trackers] == [(3, 1)] * 2


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(33)
    return (jax_convert_retinaface(random_retinaface_state_dict(rng)),
            jax_convert_arcface(random_arcface_state_dict(rng)),
            jax_convert_openpose(random_openpose_state_dict(rng)))


def lowered(pipe):
    for name, value in LOWERED_POSE_THRESHOLDS.items():
        setattr(pipe, name, value)
    return pipe


def run_streams(module, pipe, video_cls, counter_cls, **kwargs):
    """Every result of a tracked multi-stream run over 3 noise streams of
    128x192 frames (5, 4 and 2 frames: 3 batches of 4, the last padded),
    with track ids relative to ``counter_cls``'s counter at the start."""
    streams = make_streams(video_cls, [5, 4, 2], w=192, h=128, batch=2,
                           pattern="noise")
    base = counter_cls.count
    msp = module.MultiStreamPerception(pipe, streams, batch_size=4,
                                       track=True, **kwargs)
    results = [r for batch in msp for r in batch]
    for r in results:
        for face in r["faces"]:
            if face["track"] is not None:
                face["track"] -= base
    return results


@pytest.fixture(scope="module")
def tracked_runs(jax_params):
    kwargs = {"min_hits": 2, "max_age": 2}
    with lowered(PerceptionPipeline(*jax_params, device="cpu",
                                    **TINY)) as port:
        got = run_streams(port_streams, port, SyntheticVideo, KalmanTracker,
                          **kwargs)
    with lowered(JaxPipeline(*jax_params, **TINY)) as jax_pipe:
        exp = run_streams(jax_streams, jax_pipe, JaxSyntheticVideo,
                          JaxKalmanTracker, **kwargs)
    return got, exp


def test_multistream_perception_matches_jax(tracked_runs):
    got, exp = tracked_runs
    assert [(r["stream"], r["frame"]) for r in got] == [
        (r["stream"], r["frame"]) for r in exp]
    assert len(got) == 11
    faces = embedded = people = 0
    for g, e in zip(got, exp):
        assert len(g["faces"]) == len(e["faces"])
        for gf, ef in zip(g["faces"], e["faces"]):
            assert gf.keys() == ef.keys() == {"track", "bbox", "landmarks",
                                              "score"}
            assert gf["track"] == ef["track"]
            for key in ("bbox", "landmarks", "score"):
                assert np.asarray(gf[key]).dtype == np.asarray(ef[key]).dtype
                np.testing.assert_array_equal(gf[key], ef[key])
        assert g["embeddings"].shape == e["embeddings"].shape
        np.testing.assert_allclose(g["embeddings"], e["embeddings"], rtol=0,
                                   atol=2e-4)
        assert ([p["keypoints"].tolist() for p in g["pose"]]
                == [p["keypoints"].tolist() for p in e["pose"]])
        faces += len(g["faces"])
        embedded += len(g["embeddings"])
        people += len(g["pose"])
    assert faces and embedded and people, (faces, embedded, people)


def test_tracks_are_confirmed_and_per_stream(tracked_runs):
    got, _ = tracked_runs
    by_stream = {}
    for r in got:
        for face in r["faces"]:
            if face["track"] is not None:
                by_stream.setdefault(r["stream"], set()).add(face["track"])
    assert by_stream, "no confirmed tracks"
    ids = [track for tracks in by_stream.values() for track in tracks]
    assert len(ids) == len(set(ids)), "a track id crossed streams"
