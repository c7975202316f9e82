"""The port's scale-out at 2 and 4 ranks over gloo, against the JAX package.

Each rank is a process running ``tests/torch_multirank_worker.py`` (the
port, torch and numpy only; one torch thread a rank) over a loopback
coordinator, as ``tests/test_multihost.py`` runs JAX's processes; both
jobs start together when the module's fixture first runs. This process
computes the JAX side on ``create_mesh(N)`` over conftest's virtual CPU
devices, and the port's single-device side. Every ``communicate`` has
its own timeout, so a hung collective fails its test.

Tolerances:

- ``make_sharded_nms``: bit for bit against JAX's on a mesh of the same
  size (boxes, scores, keep, order, overflow), every rank alike;
- ``make_spatial_detect_fn`` and ``SpatialShardedDetector`` at 4 ranks:
  ``keep`` equal to JAX's and to the by-hand slab oracle's, boxes and
  landmarks within 1e-2 and scores within 1e-5 (``test_spatial.py``'s);
- the pipeline at 2 ranks, a full batch and a partial one of 3, at
  ``tests/test_pipeline.py``'s mesh tolerances against the port's
  single-device pipeline and the JAX class under ``create_mesh(2)``:
  ``mask`` and ``boxes`` equal, scores within 1e-5, embeddings within
  2e-4.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_multirank_worker as worker
from terran_tpu_torch.face.detection import RetinaFaceDetector
from terran_tpu_torch.models.retinaface import decode_outputs
from terran_tpu_torch.ops.nms import nms_fixed
from terran_tpu_torch.parallel.spatial import (
    ext_anchor_meta, slab_candidates,
)
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.utils.convert import (
    convert_arcface, convert_openpose, convert_retinaface,
)
from torch_port_fixtures import single_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds for each rank's communicate
# (ranks, cases) of each job; all start together.
JOBS = ((2, "nms,feed,pipeline"),
        (2, "pipeline_host,pipeline_escalation,pipeline_int8"),
        (4, "nms,submesh,spatial"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Job:
    """One multi-rank run of the worker: its processes, and their results
    once :meth:`results` has waited for them."""

    def __init__(self, nproc, cases, out):
        self.nproc, self.cases, self.out = nproc, cases, out
        env = dict(os.environ, COORD=f"127.0.0.1:{_free_port()}",
                   NPROC=str(nproc), CASES=cases, OUT=str(out),
                   TERRAN_TPU_COMPUTE_DTYPE="float32",
                   PYTHONPATH=os.pathsep.join(
                       [REPO, os.path.join(REPO, "tests"),
                        os.environ.get("PYTHONPATH", "")]))
        self.procs = [subprocess.Popen(
            [sys.executable, worker.__file__], env=dict(env, PID=str(pid)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO) for pid in range(nproc)]
        self._results = None

    def results(self):
        if self._results is None:
            outs = []
            try:
                for proc in self.procs:
                    outs.append(proc.communicate(timeout=TIMEOUT)[0])
            finally:
                self.kill()
            for pid, (proc, out) in enumerate(zip(self.procs, outs)):
                assert proc.returncode == 0, f"rank {pid} failed:\n{out}"
                assert f"MULTIRANK_OK pid={pid}" in out, out
            self._results = {
                case: [self._load(case, pid) for pid in range(self.nproc)]
                for case in self.cases.split(",")}
        return self._results

    def _load(self, case, pid):
        with open(self.out / f"{case}-rank{pid}.pkl", "rb") as f:
            return pickle.load(f)

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    started = [Job(n, cases, tmp_path_factory.mktemp(f"ranks{n}-"))
               for n, cases in JOBS]
    yield started
    for job in started:
        job.kill()


def ranks(jobs, n, case):
    """Each rank's result of ``case`` in the job of ``n`` ranks that runs
    it."""
    job, = (job for job in jobs
            if job.nproc == n and case in job.cases.split(","))
    return job.results()[case]


def assert_all_equal(per_rank):
    """Every rank returned the same nested arrays."""
    first = per_rank[0]
    for other in per_rank[1:]:
        assert_tree_equal(other, first)


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            assert_tree_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The pipeline at 2 ranks
# ---------------------------------------------------------------------------

def port_pipeline(config, det_scale=1.0):
    """The port's single-device pipeline on the worker's weights."""
    det, rec, pose = worker.pipeline_state_dicts(det_scale)
    return PerceptionPipeline(
        det_params=convert_retinaface(det), rec_params=convert_arcface(rec),
        pose_params=convert_openpose(pose), device="cpu", **config)


def jax_mesh_pipeline(config, det_scale=1.0):
    """The JAX class under ``create_mesh(2)`` on the worker's weights."""
    from terran_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from terran_tpu.pipeline import PerceptionPipeline as JaxPipeline
    from terran_tpu.utils.convert import convert_arcface as jax_arcface
    from terran_tpu.utils.convert import convert_openpose as jax_openpose
    from terran_tpu.utils.convert import (
        convert_retinaface as jax_retinaface,
    )

    det, rec, pose = worker.pipeline_state_dicts(det_scale)
    return JaxPipeline(jax_retinaface(det), jax_arcface(rec),
                       jax_openpose(pose), mesh=jax_create_mesh(2), **config)


def batch_references(config):
    """(port single-device, JAX under create_mesh(2)) results for the full
    batch and the partial one."""
    frames = worker.pipeline_frames()
    batches = {"full": frames, "partial": frames[:3]}
    port, jax_pipe = port_pipeline(config), jax_mesh_pipeline(config)
    try:
        return {name: (port.process_batch(batch),
                       jax_pipe.process_batch(batch))
                for name, batch in batches.items()}
    finally:
        port.close()
        jax_pipe.close()


@pytest.fixture(scope="module")
def pipeline_references():
    return batch_references(worker.PIPELINE_CONFIG)


@pytest.fixture(scope="module")
def host_references():
    return batch_references(dict(worker.PIPELINE_CONFIG, **worker.HOST_PLAN))


def assert_mesh_tolerances(got, expected):
    """tests/test_pipeline.py's mesh tolerances."""
    np.testing.assert_array_equal(got["mask"], expected["mask"])
    np.testing.assert_array_equal(got["boxes"], expected["boxes"])
    np.testing.assert_allclose(got["scores"], expected["scores"], atol=1e-5)
    np.testing.assert_allclose(got["embeddings"], expected["embeddings"],
                               atol=2e-4)
    np.testing.assert_array_equal(got["embeddings_mask"],
                                  expected["embeddings_mask"])


def assert_like_single_device(got, single):
    """The mesh tolerances, and the rest of the outputs equal, against the
    port's single-device result."""
    assert_mesh_tolerances(got, single)
    for key in ("landmarks", "det_overflow", "pose_overflow"):
        np.testing.assert_array_equal(got[key], single[key], err_msg=key)
    assert len(got["poses"]) == len(single["poses"])
    for frame_got, frame_expected in zip(got["poses"], single["poses"]):
        assert len(frame_got) == len(frame_expected)
        for (keypoints, score), person in zip(frame_got, frame_expected):
            np.testing.assert_array_equal(keypoints, person["keypoints"])
            np.testing.assert_allclose(score, person["score"], atol=1e-5)


def two_rank_result(jobs, case, batch):
    """Rank 0's result, after checking that both ranks returned it."""
    per_rank = [out[batch] for out in ranks(jobs, 2, case)]
    assert_all_equal(per_rank)
    got = per_rank[0]
    n = worker.PIPELINE_FRAMES[0] if batch.endswith("full") else 3
    assert got["boxes"].shape[0] == n and len(got["poses"]) == n
    assert got["mask"].any() and got["embeddings_mask"].any()
    return got


@pytest.mark.parametrize("batch", ["full", "partial"])
def test_pipeline_two_ranks(jobs, pipeline_references, batch):
    # First in the module: the references compute while the ranks run.
    got = two_rank_result(jobs, "pipeline", batch)
    single, jax_out = pipeline_references[batch]
    assert_mesh_tolerances(got, jax_out)
    assert_like_single_device(got, single)


@pytest.mark.parametrize("batch", ["full", "partial"])
def test_pipeline_two_ranks_host_plan(jobs, host_references, batch):
    """Each rank resizes, warps and uploads only its rows of the padded
    batch; the embed worker's output is gathered on the main thread. The
    stream of the same two batches through the plan's resize and upload
    threads gives the same results."""
    got = two_rank_result(jobs, "pipeline_host", batch)
    single, jax_out = host_references[batch]
    assert_mesh_tolerances(got, jax_out)
    assert_like_single_device(got, single)
    streamed = two_rank_result(jobs, "pipeline_host", f"stream_{batch}")
    assert_tree_equal(streamed, got)


def test_pipeline_two_ranks_int8(jobs):
    """The int8 trunks under a mesh against the port's single device. The
    JAX class is not run here: its int8 programs take minutes to compile
    on the CPU. The port's single-device int8 pipeline is held to the JAX
    class's in tests/test_torch_pipeline_int8.py, and the JAX class's
    sharded int8 run to its single-device one in tests/test_pipeline.py."""
    got = two_rank_result(jobs, "pipeline_int8", "full")
    with port_pipeline(worker.INT8_CONFIG) as pipe:
        single = pipe.process_batch(worker.pipeline_frames())
    assert_like_single_device(got, single)


def test_pipeline_two_ranks_escalation(jobs):
    """Detect, embed and pose escalation at 2 ranks, on a batch where only
    the first rank's frames overflow detection's pre-selection: every rank
    escalates together (a rank escalating alone would hang at the next
    gather), under both plans. Against the port's single device at the
    mesh tolerances, and against the JAX class under ``create_mesh(2)``
    with coordinates within 2 px plus 1e-4 of their size: the scaled
    weights decode boxes and landmarks ~4e6 px out, where the packages'
    float32 sums differ by ~4e-5 of those terms."""
    config = worker.ESCALATION_CONFIG
    scale = worker.ESCALATION_WEIGHT_SCALE
    frames = worker.pipeline_frames()
    with port_pipeline(dict(config, max_escalations=0, with_pose=False,
                            with_embeddings=False), scale) as pipe:
        overflow = pipe.process_batch(frames)["det_overflow"]
    np.testing.assert_array_equal(overflow, [True, False, False, False])

    per_rank = ranks(jobs, 2, "pipeline_escalation")
    escalated = {"detect": 1, "pose": 1, "embed": 1}
    for out in per_rank:
        for plan in ("device", "host"):
            assert out[plan].pop("escalations") == escalated, plan
    for plan in ("device", "host"):
        assert_all_equal([out[plan] for out in per_rank])
    got = per_rank[0]["device"]
    # The 'host' plan's redetect on its resident upload: the same result.
    assert_tree_equal(per_rank[0]["host"], got)
    assert not got["det_overflow"].any()
    assert got["embeddings"].shape[1] == 2  # grew past max_faces

    with port_pipeline(config, scale) as pipe:
        single = pipe.process_batch(frames)
        assert pipe.escalations == escalated
    assert_like_single_device(got, single)

    jax_pipe = jax_mesh_pipeline(config, scale)
    jax_out = jax_pipe.process_batch(frames)
    assert jax_pipe.escalations == escalated
    for key in ("mask", "det_overflow", "embeddings_mask", "pose_overflow"):
        np.testing.assert_array_equal(got[key], jax_out[key], err_msg=key)
    mask = got["mask"]
    for key in ("boxes", "landmarks"):
        np.testing.assert_allclose(got[key][mask], jax_out[key][mask],
                                   rtol=1e-4, atol=2, err_msg=key)
    np.testing.assert_allclose(got["scores"][mask], jax_out["scores"][mask],
                               atol=1e-5)
    valid = got["embeddings_mask"]
    np.testing.assert_allclose(got["embeddings"][valid],
                               jax_out["embeddings"][valid], atol=2e-4)


# ---------------------------------------------------------------------------
# make_sharded_nms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["overflowing", "exact"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_nms_matches_jax(jobs, n, config):
    import jax.numpy as jnp
    from terran_tpu.ops.nms import make_sharded_nms as jax_sharded_nms
    from terran_tpu.parallel.mesh import create_mesh as jax_create_mesh

    per_rank = [out[config] for out in ranks(jobs, n, "nms")]
    assert_all_equal(per_rank)
    got = per_rank[0]

    boxes, scores = worker.nms_inputs()
    threshold, local_top_k, top_k = worker.nms_configs(n)[config]
    expected = jax_sharded_nms(
        jax_create_mesh(n), iou_threshold=0.4, score_threshold=threshold,
        local_top_k=local_top_k, top_k=top_k,
    )(jnp.asarray(boxes), jnp.asarray(scores))
    for name, g, e in zip(("boxes", "scores", "keep", "order", "overflow"),
                          got, expected):
        np.testing.assert_array_equal(g, np.asarray(e), err_msg=name)
    assert got[2].any()

    single = [t.numpy() for t in nms_fixed(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.4,
        score_threshold=threshold, top_k=top_k)]
    if config == "exact":
        # No shard can drop a candidate: the single-device keep-set.
        assert not got[4]
        np.testing.assert_array_equal(got[0][got[2]], single[0][single[2]])
        np.testing.assert_array_equal(got[1][got[2]], single[1][single[2]])
    else:
        # Every shard holds more than 8 candidates above 0.3.
        assert got[4]


def test_mesh_of_the_first_ranks(jobs):
    per_rank = ranks(jobs, 4, "submesh")
    for out in per_rank:
        assert out["raised"] == "requested 5 devices, have 4"
    assert [out["member"] for out in per_rank] == [True, True, False, False]
    # The first two ranks' mesh is the 2-rank world's.
    two = [out["exact"] for out in ranks(jobs, 2, "nms")]
    for out in per_rank[:2]:
        assert_tree_equal(out["nms"], two[0])


# ---------------------------------------------------------------------------
# The multi-host feed (tests/multihost_worker.py's contract, one rank a
# process)
# ---------------------------------------------------------------------------

def test_multi_host_feed(jobs):
    from terran_tpu.ops.nms import nms_fixed as jax_nms_fixed

    per_rank = ranks(jobs, 2, "feed")
    boxes, scores = worker.nms_inputs()
    boxes, scores = boxes[:64], scores[:64]
    for pid, out in enumerate(per_rank):
        # The rows each rank fed, and only those, come back to it.
        np.testing.assert_array_equal(out["local_boxes"],
                                      boxes[pid * 32:(pid + 1) * 32])
    for key in ("keep", "scores", "boxes", "order"):
        np.testing.assert_array_equal(per_rank[1][key], per_rank[0][key])
    ob, os_, okeep, _, _ = (np.asarray(t) for t in jax_nms_fixed(
        boxes, scores, 0.4, score_threshold=0.3, top_k=64))
    keep = per_rank[0]["keep"]
    np.testing.assert_array_equal(keep, okeep)
    np.testing.assert_array_equal(per_rank[0]["scores"][keep], os_[okeep])
    np.testing.assert_array_equal(per_rank[0]["boxes"][keep], ob[okeep])


# ---------------------------------------------------------------------------
# Spatial sharding at 4 ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_detectors():
    return {scale: RetinaFaceDetector(
        params=convert_retinaface(worker.spatial_state_dict(scale)),
        device="cpu", top_k=64)
        for scale in (1.0, worker.OVERFLOW_WEIGHT_SCALE)}


@pytest.fixture(scope="module")
def jax_detectors():
    from terran_tpu.face.detection import (
        RetinaFaceDetector as JaxRetinaFaceDetector,
    )
    from terran_tpu.utils.convert import (
        convert_retinaface as jax_convert_retinaface,
    )

    return {scale: JaxRetinaFaceDetector(
        params=jax_convert_retinaface(worker.spatial_state_dict(scale)),
        top_k=64) for scale in (1.0, worker.OVERFLOW_WEIGHT_SCALE)}


def slab_oracle(model, frame, threshold, valid_w, valid_h, *, slab_h, halo,
                local_top_k, top_k, nms_threshold=0.4):
    """The port's replay of ``tests/test_spatial.py::oracle`` in one
    process: each extended slab built with explicit numpy halos, the net,
    ``slab_candidates`` per slab, one fixed-K NMS over the concatenation.
    Returns (boxes, landmarks, scores, keep, per-slab overflow)."""
    n = frame.shape[0] // slab_h
    ext_h = slab_h + 2 * halo
    anchors = torch.from_numpy(ext_anchor_meta(slab_h, frame.shape[1],
                                               halo)[0])
    cand = []
    for i in range(n):
        ext = np.zeros((ext_h,) + frame.shape[1:], frame.dtype)
        start = i * slab_h
        lo, hi = max(0, start - halo), min(frame.shape[0],
                                           start + slab_h + halo)
        ext[lo - (start - halo):hi - (start - halo)] = frame[lo:hi]
        with torch.inference_mode():
            outputs = model(torch.from_numpy(ext)[None].to(
                model.compute_dtype))
            scores, boxes, landmarks = decode_outputs(outputs, anchors)
            cand.append(slab_candidates(
                scores[0], boxes[0], landmarks[0], device_index=i,
                slab_h=slab_h, halo=halo, width=frame.shape[1],
                valid_h=valid_h, valid_w=valid_w, threshold=threshold,
                local_top_k=local_top_k))
    all_boxes = torch.cat([c[0] for c in cand])
    all_lmks = torch.cat([c[1] for c in cand])
    all_scores = torch.cat([c[2] for c in cand])
    kb, ks, keep, order, _ = nms_fixed(all_boxes, all_scores, nms_threshold,
                                       score_threshold=threshold,
                                       top_k=top_k)
    return (kb.numpy(), all_lmks[order].numpy(), ks.numpy(), keep.numpy(),
            [bool(c[3]) for c in cand])


def unpack(packed):
    from terran_tpu_torch.models.retinaface import unpack_detections

    boxes, landmarks, scores, mask, overflow = unpack_detections(
        np.asarray(packed)[None])
    return boxes[0], landmarks[0], scores[0], mask[0], bool(overflow[0])


def assert_close_detections(got, expected):
    """(boxes, landmarks, scores, keep) at test_spatial.py's tolerances."""
    boxes, landmarks, scores, keep = got
    e_boxes, e_landmarks, e_scores, e_keep = expected
    np.testing.assert_array_equal(keep, e_keep)
    assert keep.any(), "nothing kept; the comparison is vacuous"
    np.testing.assert_allclose(boxes[keep], e_boxes[keep], atol=1e-2)
    np.testing.assert_allclose(landmarks[keep].reshape(-1, 5, 2),
                               e_landmarks[keep].reshape(-1, 5, 2),
                               atol=1e-2)
    np.testing.assert_allclose(scores[keep], e_scores[keep], atol=1e-5)


def test_spatial_detect_fn_matches_jax_and_slab_oracle(jobs, port_detectors,
                                                       jax_detectors):
    from terran_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from terran_tpu.parallel.spatial import (
        make_spatial_detect_fn as jax_spatial_detect_fn,
    )

    per_rank = [out["packed"] for out in ranks(jobs, 4, "spatial")]
    assert_all_equal(per_rank)
    boxes, landmarks, scores, keep, _ = unpack(per_rank[0])
    got = (boxes, landmarks, scores, keep)

    frame = worker.spatial_frame()
    args = (worker.SPATIAL_THRESHOLD, worker.WIDTH, frame.shape[0])
    jax_det = jax_detectors[1.0]
    fn = jax_spatial_detect_fn(jax_det.model, jax_create_mesh(4),
                               worker.SLAB, worker.WIDTH, worker.HALO,
                               nms_threshold=0.4, top_k=32, local_top_k=16)
    expected = unpack(fn(jax_det.params, frame, *args))
    assert_close_detections(got, expected[:4])

    ob, ol, os_, okeep, _ = slab_oracle(
        port_detectors[1.0].model, frame, *args, slab_h=worker.SLAB,
        halo=worker.HALO, local_top_k=16, top_k=32)
    assert_close_detections(got, (ob, ol.reshape(-1, 10), os_, okeep))


def faces_arrays(faces):
    return (np.array([f["bbox"] for f in faces]),
            np.array([f["landmarks"] for f in faces]),
            np.array([f["score"] for f in faces]))


def assert_same_faces(got, expected, coords_rtol=0.0):
    """Face lists alike: scores within 1e-5, boxes and landmarks within
    1e-2 plus ``coords_rtol`` of their size."""
    assert len(got) == len(expected) and got, (len(got), len(expected))
    for g, e in zip(faces_arrays(got), faces_arrays(expected)):
        if g.ndim == 1:
            np.testing.assert_allclose(g, e, atol=1e-5)
        else:
            np.testing.assert_allclose(g, e, atol=1e-2, rtol=coords_rtol)


def test_spatial_detector_matches_jax(jobs, jax_detectors):
    from terran_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from terran_tpu.parallel.spatial import (
        SpatialShardedDetector as JaxSpatialShardedDetector,
    )

    per_rank = [out["faces"] for out in ranks(jobs, 4, "spatial")]
    for other in per_rank[1:]:
        assert_tree_equal(faces_arrays(other), faces_arrays(per_rank[0]))
    expected = JaxSpatialShardedDetector(
        jax_detectors[1.0], mesh=jax_create_mesh(4), halo=worker.HALO,
        top_k=32, local_top_k=16, max_escalations=0,
    )(worker.spatial_image(), threshold=worker.SPATIAL_THRESHOLD)
    assert_same_faces(per_rank[0], expected)
    scores = [float(f["score"]) for f in per_rank[0]]
    assert scores == sorted(scores, reverse=True)


def test_one_rank_overflow_escalates_every_rank(jobs, port_detectors,
                                                jax_detectors):
    from terran_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from terran_tpu.parallel.spatial import (
        SpatialShardedDetector as JaxSpatialShardedDetector,
    )

    frame = worker.overflow_frame()
    local_top_k = worker.OVERFLOW_LOCAL_TOP_K
    *_, slab_overflow = slab_oracle(
        port_detectors[worker.OVERFLOW_WEIGHT_SCALE].model, frame,
        worker.OVERFLOW_THRESHOLD, worker.WIDTH, frame.shape[0],
        slab_h=worker.SLAB, halo=worker.HALO, local_top_k=local_top_k,
        top_k=4 * local_top_k)
    assert sum(slab_overflow) == 1, slab_overflow  # one rank alone

    per_rank = ranks(jobs, 4, "spatial")
    # Every rank's packed result carries the all-reduced flag, and every
    # rank escalated once, together.
    assert all(unpack(out["overflow_first"])[4] for out in per_rank)
    assert [out["overflow_escalations"] for out in per_rank] == [1] * 4
    for other in per_rank[1:]:
        assert_tree_equal(faces_arrays(other["overflow_faces"]),
                          faces_arrays(per_rank[0]["overflow_faces"]))

    # The escalated capacity, replayed slab by slab.
    ob, ol, os_, okeep, slab_overflow = slab_oracle(
        port_detectors[worker.OVERFLOW_WEIGHT_SCALE].model, frame,
        worker.OVERFLOW_THRESHOLD, worker.WIDTH, frame.shape[0],
        slab_h=worker.SLAB, halo=worker.HALO, local_top_k=2 * local_top_k,
        top_k=8 * local_top_k)
    assert not any(slab_overflow)
    assert_same_faces(per_rank[0]["overflow_faces"], [
        {"bbox": b, "landmarks": l, "score": s}
        for b, l, s in zip(ob[okeep], ol[okeep], os_[okeep])])

    jax_spatial = JaxSpatialShardedDetector(
        jax_detectors[worker.OVERFLOW_WEIGHT_SCALE],
        mesh=jax_create_mesh(4), halo=worker.HALO, top_k=4 * local_top_k,
        local_top_k=local_top_k, max_escalations=2)
    expected = jax_spatial(frame, threshold=worker.OVERFLOW_THRESHOLD)
    assert jax_spatial.escalations == 1
    # The scaled weights decode boxes up to ~1e26 px, where the packages'
    # float32 sums differ by ~5e-4 of the coordinate.
    assert_same_faces(per_rank[0]["overflow_faces"], expected,
                      coords_rtol=1e-3)
