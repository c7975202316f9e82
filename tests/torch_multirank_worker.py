"""One rank of the port's multi-rank tests over gloo on the CPU.

Launched by ``tests/test_torch_multirank.py``, once per rank, with
``COORD`` (host:port of the loopback coordinator), ``NPROC``, ``PID``,
``CASES`` (comma-separated case names) and ``OUT`` (a directory) in the
environment. Each rank joins the group through
``terran_tpu_torch.parallel.initialize_multi_host``, makes a CPU mesh over
the world, runs each case on inputs made from seeds (the same on every
rank, and the same the test process makes), and pickles what the case
returns to ``OUT/{case}-rank{PID}.pkl``. Torch runs one thread a rank.
It imports only the port, torch, numpy and ``torch_oracle``; the test
process computes the JAX side and compares.
"""

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from terran_tpu_torch.face.detection import RetinaFaceDetector  # noqa: E402
from terran_tpu_torch.ops.nms import make_sharded_nms, nms_fixed  # noqa: E402
from terran_tpu_torch.parallel import (  # noqa: E402
    SpatialShardedDetector, create_mesh, global_batch_from_local,
    initialize_multi_host, local_results, make_spatial_detect_fn,
    shard_params,
)
from terran_tpu_torch.utils.convert import (  # noqa: E402
    convert_arcface, convert_openpose, convert_retinaface,
)
from torch_oracle import (  # noqa: E402
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict,
)

# Sharded NMS: 128 anchors, a tie plateau among them.
NMS_ANCHORS = 128


def nms_configs(n):
    """(score_threshold, local_top_k, top_k) at ``n`` ranks: one where the
    shards' pre-selection overflows, one exact (local_top_k the shard
    size, top_k all anchors)."""
    return {"overflowing": (0.3, 8, 24),
            "exact": (0.3, NMS_ANCHORS // n, NMS_ANCHORS)}

# Spatial: tests/test_spatial.py's geometry and weights.
SLAB, HALO, WIDTH = 64, 32, 96
SPATIAL_THRESHOLD = 0.3
# A frame where one rank alone overflows its pre-selection: the seed-7
# weights scaled by 1.2 (so that scores follow the frame's content), a
# seeded noise frame of 4 slabs, threshold 0.45; the ranks hold 222, 223,
# 222 and 222 candidates, every score at least 0.018 from the threshold.
OVERFLOW_WEIGHT_SCALE = 1.2
OVERFLOW_THRESHOLD = 0.45
OVERFLOW_LOCAL_TOP_K = 222

# The pipeline: tests/test_torch_pipeline.py's cheap capacities at the
# frame shape and sides where both packages' resizes are exact (x1/2 for
# detection, x1/4 for pose), so that the JAX class can be compared too.
PIPELINE_CONFIG = {"top_k": 16, "max_faces": 4, "max_peaks": 8,
                   "max_escalations": 0, "det_short_side": 64,
                   "pose_short_side": 32}
PIPELINE_FRAMES = (4, 128, 192, 3)
# The pipeline's other paths at 2 ranks: the 'host' transfer plan (a
# batch, then a stream through its worker threads), the int8 trunks, and
# escalation of all three stages.
HOST_PLAN = {"transfer_plan": "host", "host_resize": "exact"}
# One face slot: the CPU's int8 FaceResNet100 costs ~1 s a crop.
INT8_CONFIG = dict(PIPELINE_CONFIG, max_faces=1, embed_precision="int8",
                   pose_precision="int8")
# RetinaFace's weights scaled by 1.5 make detection follow the frame: at
# threshold 0.5 the four frames hold 87, 80, 86 and 86 candidates, so at
# top_k 86 only frame 0, the first rank's, overflows, and every rank must
# still redetect together. Every frame overflows max_faces 1 and
# max_peaks 4, so the embed and pose stages escalate too.
ESCALATION_WEIGHT_SCALE = 1.5
ESCALATION_CONFIG = dict(PIPELINE_CONFIG, threshold=0.5, top_k=86,
                         max_faces=1, max_peaks=4, max_escalations=1)


def nms_inputs():
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 80, size=(NMS_ANCHORS, 2)).astype(np.float32)
    wh = rng.uniform(4, 24, size=(NMS_ANCHORS, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=1)
    scores = rng.uniform(0, 1, size=NMS_ANCHORS).astype(np.float32)
    # A tie: identical scores across shards and within one, and two
    # identical boxes with one score.
    scores[[3, 40, 70, 100, 101]] = np.float32(0.8125)
    boxes[101] = boxes[100]
    return boxes, scores


def spatial_state_dict(scale=1.0):
    sd = random_retinaface_state_dict(np.random.default_rng(7))
    if scale != 1.0:
        sd = {k: (v * np.float32(scale) if k.endswith("weight") else v)
              for k, v in sd.items()}
    return sd


def spatial_frame():
    return np.random.default_rng(11).integers(
        0, 255, (4 * SLAB, WIDTH, 3), dtype=np.uint8)


def spatial_image():
    return np.random.default_rng(12).integers(
        0, 255, (200, 90, 3), dtype=np.uint8)


def overflow_frame():
    return np.random.default_rng(0).integers(
        0, 255, (4 * SLAB, WIDTH, 3), dtype=np.uint8)


def pipeline_state_dicts(det_scale=1.0):
    rng = np.random.default_rng(33)
    det = random_retinaface_state_dict(rng)
    if det_scale != 1.0:
        det = {k: (v * np.float32(det_scale) if k.endswith("weight") else v)
               for k, v in det.items()}
    return (det, random_arcface_state_dict(rng),
            random_openpose_state_dict(rng))


def pipeline_frames():
    return np.random.default_rng(1).integers(0, 255, PIPELINE_FRAMES,
                                             dtype=np.uint8)


def as_numpy(outputs):
    return tuple(t.numpy() for t in outputs)


def case_nms(mesh):
    boxes, scores = nms_inputs()
    out = {}
    for name, (threshold, local_top_k, top_k) in nms_configs(
            mesh.size).items():
        run = make_sharded_nms(mesh, iou_threshold=0.4,
                               score_threshold=threshold,
                               local_top_k=local_top_k, top_k=top_k)
        out[name] = as_numpy(run(boxes, scores))
    return out


def case_submesh(mesh):
    """A mesh of the first two ranks: the others get None; past the world
    size every rank raises."""
    try:
        create_mesh(mesh.size + 1, devices="cpu")
    except ValueError as exc:
        raised = str(exc)
    else:
        raise AssertionError("a mesh past the world size did not raise")
    sub = create_mesh(2, devices="cpu")
    if sub is None:
        return {"member": False, "raised": raised}
    assert sub.size == 2 and sub.rank == mesh.rank
    threshold, local_top_k, top_k = nms_configs(2)["exact"]
    run = make_sharded_nms(sub, iou_threshold=0.4, score_threshold=threshold,
                           local_top_k=local_top_k, top_k=top_k)
    return {"member": True, "raised": raised,
            "nms": as_numpy(run(*nms_inputs()))}


def case_feed(mesh):
    """tests/multihost_worker.py's flow, one rank a process."""
    boxes, scores = nms_inputs()
    boxes, scores = boxes[:64], scores[:64]
    per = len(boxes) // mesh.size
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    g_boxes = global_batch_from_local(boxes[lo:hi], mesh)
    g_scores = global_batch_from_local(scores[lo:hi], mesh)
    assert g_boxes.shape == (64, 4), g_boxes.shape
    np.testing.assert_array_equal(local_results(g_boxes, mesh), boxes[lo:hi])

    # local_top_k equals the shard size and top_k the gathered size, so
    # neither stage can overflow and the keep-set is exact.
    run = make_sharded_nms(mesh, iou_threshold=0.4, score_threshold=0.3,
                           local_top_k=per, top_k=64)
    kb, ks, keep, order, overflow = run(g_boxes, g_scores)
    ob, os_, okeep, _, _ = nms_fixed(torch.from_numpy(boxes),
                                     torch.from_numpy(scores), 0.4,
                                     score_threshold=0.3, top_k=64)
    keep = local_results(keep)
    np.testing.assert_array_equal(keep, okeep.numpy())
    np.testing.assert_array_equal(local_results(ks)[keep],
                                  os_.numpy()[okeep.numpy()])
    np.testing.assert_array_equal(local_results(kb)[keep],
                                  ob.numpy()[okeep.numpy()])
    assert not bool(overflow)

    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)
              * (1 + mesh.rank)}
    placed = shard_params(params, mesh)
    # Every rank holds the first rank's values.
    np.testing.assert_array_equal(placed["w"].numpy(),
                                  np.arange(6, dtype=np.float32).reshape(
                                      2, 3))
    return {"local_boxes": local_results(g_boxes), "keep": keep,
            "scores": local_results(ks), "boxes": local_results(kb),
            "order": local_results(order)}


def case_spatial(mesh):
    detector = RetinaFaceDetector(
        params=convert_retinaface(spatial_state_dict()), device="cpu",
        top_k=64)
    params = shard_params(detector.model.state_dict(), mesh)
    frame = spatial_frame()
    fn = make_spatial_detect_fn(detector.model, mesh, SLAB, WIDTH, HALO,
                                nms_threshold=0.4, top_k=32, local_top_k=16)
    packed = fn(params, frame, SPATIAL_THRESHOLD, WIDTH,
                frame.shape[0]).numpy()

    wrapper = SpatialShardedDetector(detector, mesh=mesh, halo=HALO,
                                     top_k=32, local_top_k=16,
                                     max_escalations=0)
    faces = wrapper(spatial_image(), threshold=SPATIAL_THRESHOLD)

    scaled = RetinaFaceDetector(
        params=convert_retinaface(spatial_state_dict(OVERFLOW_WEIGHT_SCALE)),
        device="cpu")
    # The ranks' own pre-selection overflow flags at this capacity.
    overflow_fn = make_spatial_detect_fn(
        scaled.model, mesh, SLAB, WIDTH, HALO, nms_threshold=0.4,
        top_k=4 * OVERFLOW_LOCAL_TOP_K, local_top_k=OVERFLOW_LOCAL_TOP_K)
    escalating = SpatialShardedDetector(
        scaled, mesh=mesh, halo=HALO, top_k=4 * OVERFLOW_LOCAL_TOP_K,
        local_top_k=OVERFLOW_LOCAL_TOP_K, max_escalations=2)
    frame = overflow_frame()
    first = overflow_fn(shard_params(scaled.model.state_dict(), mesh), frame,
                        OVERFLOW_THRESHOLD, WIDTH, frame.shape[0]).numpy()
    escalated = escalating(frame, threshold=OVERFLOW_THRESHOLD)
    return {"packed": packed, "faces": faces, "overflow_first": first,
            "overflow_faces": escalated,
            "overflow_escalations": escalating.escalations}


def poses_as_arrays(poses):
    return [[(p["keypoints"], np.float32(p["score"])) for p in frame]
            for frame in poses]


PIPELINE_KEYS = ("boxes", "landmarks", "scores", "mask", "det_overflow",
                 "embeddings", "embeddings_mask", "pose_overflow")


def pipeline_result(result):
    out = {key: result[key] for key in PIPELINE_KEYS}
    out["poses"] = poses_as_arrays(result["poses"])
    return out


def make_pipeline(mesh, config, det_scale=1.0):
    from terran_tpu_torch.pipeline import PerceptionPipeline

    det, rec, pose = pipeline_state_dicts(det_scale)
    pipe = PerceptionPipeline(
        det_params=convert_retinaface(det), rec_params=convert_arcface(rec),
        pose_params=convert_openpose(pose), mesh=mesh, **config)
    assert pipe.embed_dispatch == pipe.limb_dispatch == "adaptive"
    assert pipe.device == mesh.device
    return pipe


def run_batches(pipe):
    """The full batch and a partial one of 3, through process_batch."""
    frames = pipeline_frames()
    return {name: pipeline_result(pipe.process_batch(batch))
            for name, batch in (("full", frames), ("partial", frames[:3]))}


def case_pipeline(mesh):
    return run_batches(make_pipeline(mesh, PIPELINE_CONFIG))


def case_pipeline_host(mesh):
    """The 'host' plan: each rank resizes and warps only its rows, and the
    embed worker's output is gathered on the main thread; then the same
    two batches as a stream through the resize and upload threads."""
    with make_pipeline(mesh, dict(PIPELINE_CONFIG, **HOST_PLAN)) as pipe:
        out = run_batches(pipe)
        frames = pipeline_frames()
        streamed = list(pipe.process_stream([frames, frames[:3]]))
    out["stream_full"], out["stream_partial"] = map(pipeline_result,
                                                    streamed)
    return out


def case_pipeline_int8(mesh):
    pipe = make_pipeline(mesh, INT8_CONFIG)
    return {"full": pipeline_result(pipe.process_batch(pipeline_frames()))}


def case_pipeline_escalation(mesh):
    """Escalation under both plans, on the full batch."""
    out = {}
    for plan, extra in (("device", {}), ("host", HOST_PLAN)):
        with make_pipeline(mesh, dict(ESCALATION_CONFIG, **extra),
                           ESCALATION_WEIGHT_SCALE) as pipe:
            out[plan] = pipeline_result(pipe.process_batch(
                pipeline_frames()))
            out[plan]["escalations"] = dict(pipe.escalations)
    return out


CASES = {"nms": case_nms, "submesh": case_submesh, "feed": case_feed,
         "spatial": case_spatial, "pipeline": case_pipeline,
         "pipeline_host": case_pipeline_host,
         "pipeline_int8": case_pipeline_int8,
         "pipeline_escalation": case_pipeline_escalation}


def main():
    torch.set_num_threads(1)
    pid = int(os.environ["PID"])
    initialize_multi_host(coordinator_address=os.environ["COORD"],
                          num_processes=int(os.environ["NPROC"]),
                          process_id=pid, initialization_timeout=60)
    mesh = create_mesh(devices="cpu")
    assert mesh.size == int(os.environ["NPROC"]) and mesh.rank == pid
    for name in os.environ["CASES"].split(","):
        result = CASES[name](mesh)
        with open(os.path.join(os.environ["OUT"], f"{name}-rank{pid}.pkl"),
                  "wb") as f:
            pickle.dump(result, f)
        print(f"CASE_OK {name} pid={pid}", flush=True)
    torch.distributed.destroy_process_group()
    print(f"MULTIRANK_OK pid={pid}", flush=True)


if __name__ == "__main__":
    main()
