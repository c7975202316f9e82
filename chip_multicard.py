#!/usr/bin/env python3
"""Scale-out across the cards of one host, one process per card.

Run from the repository root on a machine with N >= 2 CUDA cards:

    torchrun --standalone --nproc-per-node=N chip_multicard.py

Each rank joins the group with ``initialize_multi_host()`` (torchrun's
variables; NCCL for CUDA tensors), makes the mesh over every rank with
``create_mesh()`` (rank r on ``cuda:r``) and holds the multi-card paths
against single-card ones on the same inputs (any failure raises on every
rank together, exits nonzero and prints no result line):

1. the pipeline at bench.py's configuration (chip_smoke.py's PIPE_CONFIG,
   bf16) under the mesh, a global batch of 8 1080p frames a card: one
   batch with deterministic cuDNN, each rank's rows of the result equal
   bit for bit to a no-mesh pipeline run on those rows alone on its card
   (the same programs at the same shapes, both eager: the no-mesh
   pipeline's CUDA graphs are set aside for it); then 3 timed
   ``process_stream`` sweeps of 8 global batches, the kernels' launches
   counted on every rank, beside the no-mesh pipeline at 8 frames a batch
   on rank 0's card alone, which replays its CUDA graphs while the mesh
   runs eager (the other ranks wait in a gloo barrier, which
   blocks on a socket instead of spinning on a CUDA sync); each rank's
   ``StageTimer`` ms a batch by stage is printed for both, so that the
   host work every rank repeats for the global batch (planning the
   embeds, assembling the poses) shows apart from the gathers;
2. ``make_sharded_nms`` over the N ranks on one frame's 12,740 decoded
   anchors, every shard's anchors pre-selected, against ``nms_fixed`` on
   one card: equal;
3. ``SpatialShardedDetector`` over the N ranks (halo 256, top_k 256, no
   escalation, bf16) on a seeded 2160x3840 frame, the halos sent between
   the cards, against chip_smoke.py's N-slab replay of the frame on each
   rank's own card: the same faces; timed beside the same detector on a
   mesh of rank 0 alone.

Rank 0 prints every card's name and power limit (nvidia-smi) and one
``{"multicard": ...}`` JSON line, then ``{"ok": true, ...}``. With
``--cpu`` it rehearses the same steps on the CPU over gloo at a tiny size
(no card needed; the kernels' plain versions, so no launches counted).
It imports nothing of JAX or of the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
SWEEPS = 3
BATCHES = 8


def agree(ok, what, mesh):
    """Raise on every rank when ``ok`` is False on any rank, so that no
    rank waits in a later collective for one that failed."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(bool(ok))], dtype=torch.int32,
                        device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    if not int(flag):
        raise AssertionError(f"{what}: failed on some rank")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse on the CPU over gloo at a tiny size")
    args = parser.parse_args()
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    os.environ.setdefault("TERRAN_TPU_HOME",
                          str(REPO / "build" / "terran-home"))
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as smoke
    from terran_tpu_torch.face.detection import RetinaFaceDetector
    from terran_tpu_torch.models.retinaface import (
        anchors_for_shape, decode_outputs,
    )
    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops import nms
    from terran_tpu_torch.parallel import (
        SpatialShardedDetector, create_mesh, initialize_multi_host,
    )
    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.utils.convert import (
        convert_arcface, convert_openpose, convert_retinaface,
    )
    from terran_tpu_torch.utils.profiling import StageTimer
    from torch_oracle import (
        random_arcface_state_dict, random_openpose_state_dict,
        random_retinaface_state_dict,
    )

    if args.cpu:
        frame_shape, per_card, big_frame = (96, 128), 2, (200, 300)
        config = dict(smoke.PIPE_CONFIG, top_k=16, max_faces=2, max_peaks=8,
                      det_short_side=64, pose_short_side=48)
        devices = "cpu"
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available():
            print("chip_multicard: no CUDA device is available",
                  file=sys.stderr)
            return 2
        frame_shape, per_card, big_frame = (smoke.FRAME, smoke.BATCH,
                                            smoke.TILED_FRAME)
        config, devices = smoke.PIPE_CONFIG, None
    initialize_multi_host(initialization_timeout=300)
    if not dist.is_initialized():
        raise SystemExit("chip_multicard: run it under torchrun")
    mesh = create_mesh(devices=devices)
    n, rank, dev = mesh.size, mesh.rank, mesh.device
    if not args.cpu and ("nccl" not in mesh.backend
                         or dev != torch.device("cuda", rank) or n < 2):
        raise AssertionError(f"mesh: backend {mesh.backend}, device {dev}, "
                             f"{n} ranks")
    lead = rank == 0
    # The ranks that wait while rank 0 times one card alone wait here.
    waiters = dist.new_group(backend="gloo")

    def log(*parts):
        if lead:
            print(*parts, flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cards = "CPU rehearsal" if args.cpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().replace("\n", "; ")
    log(f"cards: {cards}; {n} ranks, backend {mesh.backend}; torch "
        f"{torch.__version__}")

    rng = np.random.default_rng(SEED)
    pose = convert_openpose(random_openpose_state_dict(rng))
    face_rng = np.random.default_rng(SEED + 1)
    rf = convert_retinaface(random_retinaface_state_dict(face_rng))
    arc = convert_arcface(random_arcface_state_dict(face_rng))
    kwargs = dict(config, det_params=rf, rec_params=arc, pose_params=pose)
    frames_rng = np.random.default_rng(SEED + 2)
    batches = [frames_rng.integers(0, 255, (n * per_card,) + frame_shape
                                   + (3,), dtype=np.uint8)
               for _ in range(BATCHES)]

    # 1. The pipeline under the mesh; each rank's rows against a no-mesh
    # pipeline over those rows alone on its card.
    meshed = PerceptionPipeline(mesh=mesh, timer=StageTimer(), **kwargs)
    single = PerceptionPipeline(device=dev, timer=StageTimer(), **kwargs)
    meshed.warmup(n * per_card, *frame_shape)
    single.warmup(per_card, *frame_shape)
    own = slice(rank * per_card, (rank + 1) * per_card)
    torch.backends.cudnn.deterministic = True
    # The mesh pipeline runs its programs' eager launches: so does the
    # no-mesh one here, its captured CUDA graphs set aside.
    graphs, single._graphs = single._graphs, {}
    try:
        got = meshed.process_batch(batches[0])
        expected = single.process_batch(batches[0][own])
    finally:
        torch.backends.cudnn.deterministic = False
        single._graphs = graphs
    keys = ("boxes", "landmarks", "scores", "mask", "det_overflow",
            "embeddings", "embeddings_mask", "pose_overflow")
    same = all(np.array_equal(got[k][own], expected[k]) for k in keys) and (
        [[(p["keypoints"].tolist(), p["score"]) for p in f]
         for f in got["poses"][own]]
        == [[(p["keypoints"].tolist(), p["score"]) for p in f]
            for f in expected["poses"]])
    agree(same, "mesh pipeline rows vs a no-mesh pipeline on them", mesh)
    agree(got["boxes"].shape[0] == n * per_card, "the global result", mesh)

    for _ in meshed.process_stream(batches[:2]):
        pass
    meshed.timer.reset()
    fps, launches = [], {"fused_peaks": 0, "nms": 0}
    for _ in range(SWEEPS):
        fp.find_peaks_fused.launches = 0
        nms.suppress.launches = 0
        dist.barrier()
        start = time.perf_counter()
        outs = list(meshed.process_stream(batches))
        sync()
        fps.append(n * per_card * BATCHES / (time.perf_counter() - start))
        launches["fused_peaks"] += fp.find_peaks_fused.launches
        launches["nms"] += 2 * nms.suppress.launches
        for out in outs:
            smoke.check_pipeline_result(out, n * per_card, config)
    swept = SWEEPS * BATCHES
    agree(args.cpu or min(launches.values()) >= 2 * swept,
          f"kernel launches on every mesh batch ({launches})", mesh)

    def stage_ms(timer):
        """ms a batch by stage over the sweeps."""
        return {name: round(1e3 * row["total_s"] / swept, 3)
                for name, row in sorted(timer.summary().items())}

    stages_by_rank = [None] * n
    dist.all_gather_object(stages_by_rank, stage_ms(meshed.timer),
                           group=waiters)
    single_fps, single_stages = [], None
    if lead:
        local = [b[:per_card] for b in batches]
        for _ in single.process_stream(local[:2]):
            pass
        single.timer.reset()
        for _ in range(SWEEPS):
            start = time.perf_counter()
            for out in single.process_stream(local):
                smoke.check_pipeline_result(out, per_card, config)
            sync()
            single_fps.append(per_card * BATCHES
                              / (time.perf_counter() - start))
        single_stages = stage_ms(single.timer)
    dist.barrier(group=waiters)
    median = sorted(fps)[len(fps) // 2]
    single_median = sorted(single_fps)[len(single_fps) // 2] if lead else 1
    log(f"pipeline over {n} cards ({config}, {per_card} frames of "
        f"{frame_shape[0]}x{frame_shape[1]} a card a batch): frames/s "
        + ", ".join(f"{f:.2f}" for f in fps)
        + f" (median {median:.2f}); one card without a mesh at "
        f"{per_card} frames a batch: "
        + ", ".join(f"{f:.2f}" for f in single_fps)
        + f" (median {single_median:.2f}); {median / single_median:.2f}x; "
        f"each rank's rows equal bit for bit to a no-mesh pipeline on them; "
        f"rank 0's launches per batch {launches['fused_peaks'] / swept:g} "
        f"(peaks), {launches['nms'] / swept:g} (nms)")
    for r, stages in enumerate(stages_by_rank):
        log(f"rank {r} ms a batch by stage under the mesh: {stages}")
    log(f"rank 0 ms a batch by stage on one card alone: {single_stages}")
    del meshed, single

    # 2. The sharded NMS over the ranks against nms_fixed on one card.
    detector = RetinaFaceDetector(params=rf, device=dev)
    resized, _ = smoke.detector_resize(detector, batches[0][:1])
    with torch.inference_mode():
        scores, boxes, _ = decode_outputs(
            detector.model(resized.to(detector.model.compute_dtype)),
            torch.from_numpy(anchors_for_shape(*resized.shape[1:3])).to(dev))
    boxes, scores = boxes[0].float(), scores[0].float()
    usable = scores.shape[0] // n * n
    boxes, scores = boxes[:usable], scores[:usable]
    run = nms.make_sharded_nms(mesh, iou_threshold=0.4, score_threshold=0.5,
                               local_top_k=usable // n, top_k=256)
    sharded = run(boxes, scores)
    direct = nms.nms_fixed(boxes, scores, 0.4, score_threshold=0.5,
                           top_k=256)
    agree(all(torch.equal(g, e) for g, e in zip(
        (sharded[0], sharded[1], sharded[2], sharded[4]),
        (direct[0], direct[1], direct[2], direct[4]))),
        "make_sharded_nms over the ranks vs nms_fixed", mesh)
    log(f"make_sharded_nms over {n} ranks == nms_fixed on {usable} decoded "
        f"anchors ({int(direct[2].sum())} kept, overflow "
        f"{bool(direct[4])})")

    # 3. The spatial detector over the ranks against the N-slab replay.
    frame = np.random.default_rng(SEED + 6).integers(
        0, 255, big_frame + (3,), dtype=np.uint8)
    spatial = SpatialShardedDetector(detector, mesh=mesh, halo=256,
                                     top_k=256, max_escalations=0)
    spatial(frame, 0.5)  # warm
    times = []
    for _ in range(SWEEPS):
        dist.barrier()
        start = time.perf_counter()
        faces = spatial(frame, 0.5)
        sync()
        times.append(1e3 * (time.perf_counter() - start))
    replayed, _, _ = smoke.slab_replay(
        detector.model, frame, n, spatial.halo, 0.5, 256, 256,
        detector.nms_threshold, dev)
    try:
        err = smoke.kept_error(smoke.faces_arrays(faces), replayed,
                               "spatial over the ranks vs the replay")
        ok = True
    except AssertionError as exc:
        err, ok = str(exc), False
    agree(ok, f"spatial over the ranks vs the {n}-slab replay ({err})",
          mesh)
    alone = create_mesh(1, devices=devices)
    one_ms = []
    if alone is not None:
        one = SpatialShardedDetector(detector, mesh=alone, halo=256,
                                     top_k=256, max_escalations=0)
        one(frame, 0.5)
        for _ in range(SWEEPS):
            start = time.perf_counter()
            one(frame, 0.5)
            sync()
            one_ms.append(1e3 * (time.perf_counter() - start))
    dist.barrier(group=waiters)
    spatial_ms = sorted(times)[len(times) // 2]
    one_card_ms = sorted(one_ms)[len(one_ms) // 2] if lead else 1
    log(f"SpatialShardedDetector over {n} cards ({big_frame[0]}x"
        f"{big_frame[1]}, halo 256, top_k 256): {len(faces)} faces, equal "
        f"to the {n}-slab replay on each card (max abs error {err:.2e}); "
        f"{spatial_ms:.2f} ms a call (median of {SWEEPS}) against "
        f"{one_card_ms:.2f} ms on one card")

    log(json.dumps({"multicard": {
        "ranks": n, "backend": mesh.backend, "cards": cards,
        "pipeline_frames_per_s": median, "pipeline_frames_per_s_sweeps": fps,
        "one_card_frames_per_s": single_median,
        "one_card_frames_per_s_sweeps": single_fps,
        "stage_ms_per_batch_by_rank": stages_by_rank,
        "one_card_stage_ms_per_batch": single_stages,
        "frames_per_card_per_batch": per_card,
        "launches_per_batch_rank0": {k: v / swept
                                     for k, v in launches.items()},
        "spatial_ms": spatial_ms, "spatial_ms_calls": times,
        "spatial_one_card_ms": one_card_ms, "spatial_faces": len(faces),
        "spatial_max_abs_err": err,
    }}))
    log(cards)
    if lead and not args.cpu:
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
