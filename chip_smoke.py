#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises, exits nonzero and prints no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
   scipy's version (the tracker needs it: an ImportError fails the run),
   where ffmpeg and feh are, and whether Pillow, pycairo, click, requests
   and matplotlib import (recorded only);
2. build the hand-written kernels with nvcc, one build per source, in
   parallel: terran_tpu_torch/csrc/fused_peaks.cu (the tile scan and the
   plane merge), terran_tpu_torch/csrc/nms.cu (the IoU bitmask and the
   greedy sweep), csrc/quant_conv.cu (the int8 conv's passes) and
   csrc/conv_epilogue.cu (the floating-point convs' epilogue); then the
   native pose assembly
   (terran_tpu_torch/native/assembly.cpp) with g++, which must load;
3. hold the peak kernels against their plain PyTorch version on the card, exact
   equality of coords, valid, overflow and scores, on random fields,
   off-grid gaussian bumps, a height and width off the kernel's tile grid,
   exact-tie plateaus (one of them a whole 23x40 plane, every interior
   pixel a peak, at K=128 and K=4096), batch dims, the model's own
   heatmaps at the main path's shape at K = 0, 1, 16, 32, 37 and 128, the
   strided [..., :18] view of the model's 19 channels, a 46x80 field
   (short side 368) at K=512 and a 132x264 field of 1089 tiles; hold the
   merge kernel alone against ``merge_candidates`` on the scan kernel's
   output; time the call with CUDA events at K=16, 32 and 128 (BODY_25's
   25-part view is held in phase 4, ``body25_peaks_phase``);
   then hold the NMS kernels against their plain version: all five
   outputs of ``nms_fixed`` equal (NaNs counted equal) on random boxes
   (N=8, A=12,740 anchors, K = 64, 65, 100, 256 and 4096), the model's
   own decoded boxes at the main shape (K = 64, 256, 512, 1024), K = 2048 and
   4096 at N=2, a tie plateau of identical boxes, inf and NaN boxes, no
   candidate above the threshold, survivors only in the last chunk, top_k
   above A and N=1; hold the mask kernel's words alone against the packed
   plain IoU bits on the model's boxes at K=1024; time the suppression
   with CUDA events at N=8, K=64, 256 and 1024, and count the chunks its
   sweep decides in the busiest image; the limb scores sampled from the
   x1 PAF field (``limb_scores_sampled``) equal to the materialised form
   on the model's PAFs and peaks at the pipeline's K=16, both timed with
   CUDA events;
4. the pose task API (``Estimation``) on 8 seeded 1080p
   frames at the default short side 184, full OpenPose with random
   reference-format weights, bf16; the peak kernels' launch count must
   rise; then ``max_peaks=4`` must escalate;
   the detection task API: ``Detection`` on the same frames at the
   default short side 416, full RetinaFace (mnet-0.25) with random
   weights, bf16; the NMS kernels' launch count must rise;
   the recognition task API: ``Recognition`` on the same frames, 8 faces
   a frame with finite landmarks, full FaceResNet100, bf16;
   the main path, ``PerceptionPipeline`` at bench.py's configuration
   (PIPE_CONFIG: top_k 64, max_faces 8, max_peaks 16, depth 2, no
   escalation) with the same three models: ``warmup``, one
   ``process_batch``, one ``dispatch_batch`` on resident frames that must
   make no synchronizing call (``torch.cuda.set_sync_debug_mode("error")``),
   then 3 timed ``process_stream`` sweeps over 8 seeded
   batches of 8 1080p frames, each result's shapes checked; it prints
   frames/s and the ``StageTimer`` summary; every device-program call of
   the sweeps must replay a graph and every batch call its perception and
   pose programs once (the kernels of those replays are counted in phase
   6); then ``max_escalations=2`` on 2 frames must raise every
   escalation counter (detect, pose, embed);
   the pipeline's CUDA graphs (``graphs_phase``): ``process_stream``
   (depth 2) over 4 distinct seeded 1080p batches, replaying the graphs
   ``warmup`` captured, equals the same stream down the eager closures
   bit for bit, every output, pose, peak table and limb table, at
   bench.py's configuration and at top_k 4 with a keypoint threshold that
   puts the embed and limb programs at buckets below their maximum; the
   fused embed and limbs on one batch likewise;
   the conv epilogue (``conv_epilogue_phase``): one eager
   ``process_batch`` of a fresh bf16 pipeline at bench.py's configuration
   launches ``ops/conv_epilogue.py``'s kernel once for each floating-point
   conv and standalone affine of each model call (RetinaFace 56,
   FaceResNet100 153, OpenPose 92, counted by forward hooks), counted by
   mode where it launches; those launches, rebuilt on seeded tensors of
   their shapes and layouts with NaN, +-inf and -0 among them, the kernel
   equal to its plain version bit for bit out of place and in place
   (raises otherwise), then replayed in one CUDA graph each way and timed
   by CUDA events (no profiler before phase 6): the kernel, its plain
   version and the eager chain it replaced, beside its byte bound (each
   output read and written once, each residual read once, at 3.35 TB/s),
   and the largest call alone;
   this slice's main path, concurrent streams: 4 seeded 1080p
   ``SyntheticVideo`` noise streams of 16 frames (source batch 4) through
   ``MultiStreamPerception`` on the warm pipeline, batch 8, tracking on, 2
   timed sweeps of 8 batches: every (stream, frame) exactly once, every
   batch's perception and pose programs called before it is yielded and
   every program call a replay (their kernels counted in phase 6),
   frames/s beside plain
   ``process_stream`` over the same multiplexed batches, the host time in
   ``Sort.update``; the faces, tracks, embeddings and poses equal to
   ``process_batch`` on those batches plus a fresh ``Sort`` per stream;
   the same pipeline under ``transfer_plan='host'`` (host resizes, host
   face warps, crops uploaded), once with bench.py's ``host_resize``
   ('auto': OpenCV where it imports) and once with the exact chain (the
   numpy warp): each ``warmup``, one batch, one
   ``dispatch_batch`` of a prepared batch under the sync check, 3 timed
   sweeps, both kernels exactly 2 launches per batch; it prints frames/s
   beside the device plan's, the upload bytes a frame of both plans and
   the plan that bench.py's rule would pick;
   host assembly, native against Python, on synthetic decode outputs of a
   batch at K=16 with accepted limbs: times, and the same humans;
   tiled detection: ``TiledDetector`` (tile 1024, overlap 256) on a
   seeded 2160x3840 frame, 15 tiles sliced on the card (equal to the
   host's), the merge's NMS on the card (one call more than the tiles'),
   each kept face a tile's detection at its origin, timed;
   recognition without landmarks on 8 crops of assorted sizes: the
   card's resize + pad against the CPU's, unit (8, 512) embeddings;
   the user's start from the store (``store_phase``): the three seeded
   reference-format state dicts written as .pth files, then ``python3 -m
   terran_tpu_torch.cli checkpoint convert`` of each into a fresh store
   under build/, ``checkpoint list`` and ``info``, each in a process of
   its own; ``Detection()``, ``Recognition()``, ``Estimation()`` and
   ``PerceptionPipeline(**PIPE_CONFIG)`` built with no ``params=`` equal
   their ``params=`` twins bit for bit, the kernels launched in each;
   ``examples/torch_streams.py --synthetic 2 --frames 16 --batch-size 8``
   as a process on the card (32 frames over 2 streams); ``vis_*`` where
   Pillow or pycairo imports and ``open_image``/``resolve_images`` where
   Pillow does, else the logged fact that they cannot run there;
   ``checkpoint delete``, then ``info`` says NOT_DOWNLOADED;
   the opt-in int8 trunks (their product is ``torch._int_mm``, a library
   call, not a kernel of the repository): every distinct quantised conv
   of Int8FaceResNet100 and Int8BodyPoseModel at the pipeline's shapes
   (64 crops; 8 frames at pose side 184), bf16, the im2col + _int_mm path
   against the plain float64 conv on the card (int32 accumulators, scale
   and outputs equal), its call ms beside cuDNN's bf16 conv of the shape
   and its bound; both task APIs with 'int8', ms a call beside native;
   right after the native pipeline, this slice's main path: the same
   pipeline with ``embed_precision='int8', pose_precision='int8'``
   (warmup, one batch, a dispatch under the sync check, 3 timed sweeps,
   each kernel exactly 2 launches a batch, the _int_mm calls a batch);
   then BODY_25 (``body25_phase``): ``PerceptionPipeline(pose='body25')``
   at published widths, pose short side 368, no recognizer, bf16:
   ``process_stream`` over the 8 batches before ``warmup`` with the
   kernels' launch counts set to 0 just before it (each pair 2 launches a
   batch, 25-part peak tables for every frame, peaks found, poses of 25
   keypoints), and the conv epilogue launched once for each BODY_25 and
   RetinaFace conv of each call, then one batch's epilogues checked and
   timed as above; the peak kernel against its plain version on the strided
   [..., :25] view of a (8, 46, 81, 78) box-blurred noise field and of
   the model's own output (132 tiles a plane) at K=16, 128 and 512 (the
   last holds every peak of the noise field), timed at K=16; then ``warmup`` and 3 timed sweeps, every call a replay;
   after the host plan, this slice's main path, scale-out over
   torch.distributed (``scaleout_phase``): ``create_mesh()`` brings up a
   world-1 NCCL group on cuda:0 over a loopback store; the pipeline at
   bench.py's configuration under the mesh equals the pipeline without
   one bit for bit on a batch, and both are timed over interleaved
   sweeps (both kernels on every mesh batch); ``make_sharded_nms`` at
   world 1 equals ``nms_fixed``; ``SpatialShardedDetector`` at world 1 on
   a seeded 2160x3840 frame equals the detector's model on the frame
   between zero halos; the frame's 4-slab layout replayed slab by slab
   on the card in float32 (TF32 off, merged by ``nms_fixed`` there)
   equals the same replay on the CPU; the group is destroyed before the
   next phase;
5. float32 with TF32 off: the fused path and the materialised path
   (``fused_peaks='off'``) give equal keypoints, and the card's forward
   agrees with the CPU's on a small input; the same for RetinaFace and
   ArcFace, and the detect step's keep masks on the card equal the CPU's;
   the pipeline's ``process_stream`` equals its ``process_batch`` on the
   card, and the card's pipeline agrees with a CPU pipeline on a small
   input (``pipeline_float32_phase`` states the tolerances); the host
   plan against the device plan on the card at dyadic scales
   (``pipeline_host_float32_phase``); both int8 trunks through the
   _int_mm path equal the same modules through the plain float64 convs
   on the card, and the int8 embeddings' cosine to float32;
6. ``torch.profiler``: the CUDA kernels of one peak-scan call (at most 2),
   the kernels' device time at K=16, 32 and 128, and the CUDA kernels of
   one NMS suppression call (2: mask and sweep) with each one's device
   time at K=64, 256 and 1024; the kernel launches of the warm pipeline's
   ``process_stream``, of the concurrent streams and of the BODY_25
   pipeline's ``process_stream``, from the profiler's
   kernel records of one sweep each like the timed ones (a replayed CUDA
   graph's kernels are recorded there, and the kernels' Python counters
   do not see them; the profiler comes last because it stays attached to
   the process and slows later launches): exactly 2 of each pair a batch,
   every program call a replay; then, last, the package's runtime and
   tracing names (``observability_phase``): ``platform()`` is 'gpu' and
   ``available_devices()`` the visible cards, a float32
   ``set_default_policy`` reaches a ``Detection`` built with no
   ``compute_dtype``, and ``start_trace``/``stop_trace`` around 2 batches
   of a warm pipeline at bench.py's configuration, each inside
   ``trace("pipeline_batch")``, write a ``*.pt.trace.json`` that must hold
   the region and the four kernels (scan, merge, mask, sweep), 2 of each
   pair a batch; the global
   timer counts 2 regions and a second ``start_trace`` raises;
7. JSON lines describing the pipeline, its host plan, the streams, the
   int8 trunks and their conv shapes, the BODY_25 pipeline, the tiled
   call, the scale-out
   phase, recognition without landmarks, the store phase, the
   observability phase and the kernels, then the card's line, then the
   result line.

It imports nothing of JAX or of the JAX package.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
SEED = 0
BATCH = 8
FRAME = (1080, 1920)
TIMED_CALLS = 3
PLATEAU_PEAKS = (23 * 8 - 2) * (40 * 8 - 2)  # interior of a 184x320 field
# H100 SXM published peaks: float32 outside the tensor cores, HBM3.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# Dense int8 tensor-core rate (the int8 trunks' products).
PEAK_INT8_OPS = 1979e12
CROP = 112        # FaceResNet100's input side
POSE_SIDE = 184   # the pose short side of the task API and the pipeline
DETECT_SHAPE = (416, 739)  # 1080p at the default short side 416
ANCHORS = 12740            # RetinaFace anchors at 416x739
FACES_PER_FRAME = 8
# The perception pipeline at bench.py's configuration (bench.py:430-442,
# 485): batch 8 of 1080p, top_k 64, max_faces 8, max_peaks 16, depth 2,
# no escalation, timed over 3 sweeps of 8 batches.
PIPE_CONFIG = {"top_k": 64, "max_faces": 8, "max_peaks": 16,
               "max_escalations": 0}
PIPE_BATCHES = 8
PIPE_SWEEPS = 3
PIPE_DEPTH = 2
# CUDA graphs against eager launches: distinct batches through a depth-2
# stream, and the top_k at which every frame's faces fit a bucket below
# max_faces.
GRAPH_BATCHES = 4
GRAPH_TOP_K = 4
# Concurrent streams (examples/streams.py, BASELINE.md config 5): 4 seeded
# 1080p noise streams of 16 frames read 4 at a time, through the warm
# pipeline at batch 8 with tracking, 2 timed sweeps of 8 batches.
STREAMS = 4
STREAM_FRAMES = 16
STREAM_SOURCE_BATCH = 4
STREAM_SWEEPS = 2
# Tiled detection: one 2160x3840 frame in 15 tiles of 1024, overlap 256.
TILED_FRAME = (2160, 3840)
TILE = 1024
TILE_OVERLAP = 256
# Scale-out: the 4K frame's 4-slab layout replayed on one card.
SCALEOUT_SLABS = 4
# Whole-face crops for recognition without landmarks: upscaled and
# downscaled, odd aspect ratios, a side of one pixel, a square.
NO_LANDMARK_SHAPES = [(37, 51), (200, 160), (112, 112), (640, 480),
                      (90, 300), (1, 80), (150, 150), (1080, 1920)]
# The store phase: a fresh checkpoint home and the reference-format .pth
# files, under build/; the streams example's run.
STORE_DIR = REPO / "build" / "store"
STORE_IDS = {"retinaface": "b5d77fff", "arcface": "d206e4b0",
             "openpose": "11a769ad"}
STORE_STREAMS = 2
STORE_STREAM_FRAMES = 16
LEAF_LIBRARIES = ("PIL", "cairo", "click", "requests", "matplotlib")
TRACE_DIR = REPO / "build" / "observability"
TRACED_BATCHES = 2
TRACE_KERNELS = ("scan_kernel", "merge_kernel", "mask_kernel", "sweep_kernel")
# float32 operations of one IoU test in csrc/nms.cu: 2 max, 2 min, 2
# subtractions, 2 clamps, 1 product, 2 additions/subtractions, 1 division,
# 1 compare.
IOU_OPS = 13


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters=20, warm=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line():
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return result.stdout.strip().splitlines()[0]


def bumps(shape, per_plane, rng):
    """Off-grid gaussian bumps, ``per_plane`` per (image, part) plane."""
    import numpy as np

    n, h, w, parts = shape
    yy, xx = np.mgrid[0:h, 0:w]
    heat = np.zeros(shape, np.float32)
    for i in range(n):
        for p in range(parts):
            for _ in range(per_plane):
                cy, cx = rng.uniform(1, h - 1), rng.uniform(1, w - 1)
                heat[i, :, :, p] += rng.uniform(0.3, 1.0) * np.exp(
                    -((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0
                )
    return heat


def assert_same(got, expected, label):
    import torch

    names = ("coords", "scores", "valid", "overflow")
    for name, g, e in zip(names, got, expected):
        if g.shape != e.shape or g.dtype != e.dtype or not torch.equal(g, e):
            raise AssertionError(f"{label}: kernel and plain version differ "
                                 f"in {name}")


def profile_call(fn, calls, counts=None):
    """(CUDA kernels per call, device ms per call, {kernel name: device ms
    per call}) of ``calls`` calls of ``fn`` under torch.profiler; every
    device activity but the step annotation counts as a kernel. The
    profiler's schedule runs one warm-up call with the device tracing
    already on, whose records it drops, so the measured calls start on a
    running trace. The profiler still loses records now and then (17 of 20
    calls' two kernels once), so a kernel's ms a call is its mean over the
    records seen times its launches a call, rounded. ``counts``, a dict,
    receives the records seen for each kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    # The schedule's "ProfilerStep*" annotation is also a device event.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.key.startswith("ProfilerStep")]
    # "(anonymous namespace)::scan_kernel(float const*, ...)" -> scan_kernel
    device_ms, records = {}, {}
    for e in events:
        name = re.search(r"(\w+)\(", e.key)
        name = name.group(1) if name else e.key
        device_ms[name] = (device_ms.get(name, 0.0)
                           + e.self_device_time_total / 1e3)
        records[name] = records.get(name, 0) + e.count
    if counts is not None:
        counts.update(records)
    by_name = {name: device_ms[name] / n * max(1, round(n / calls))
               for name, n in records.items()}
    return (sum(records.values()) / calls, sum(by_name.values()), by_name)


def kernel_launches(fn):
    """{"fused_peaks": scan + merge records, "nms": mask + sweep records}
    of one call of ``fn``, from torch.profiler's kernel records (through
    ``profile_call``, which calls ``fn`` three times), as the benchmark
    counts launches: a replayed CUDA graph's kernels are recorded there,
    while the kernels' Python counters see only eager launches."""
    counts = {}
    profile_call(fn, 1, counts)
    return {"fused_peaks": (counts.get("scan_kernel", 0)
                            + counts.get("merge_kernel", 0)),
            "nms": counts.get("mask_kernel", 0) + counts.get("sweep_kernel", 0)}


def check_launches(launches, batches, what):
    """Both kernels on every batch: exactly 2 launches a batch of each
    pair."""
    for name, count in launches.items():
        if count != 2 * batches:
            raise AssertionError(f"{what} launched {name}'s kernels {count} "
                                 f"times over {batches} batches, expected "
                                 f"{2 * batches}")


def dispatched(pipe, since=(0, 0)):
    """(perception programs, pose programs) the pipeline has called since
    ``since``, from its StageTimer: a batch records ``perception_step`` and
    ``pose_dispatch`` once each, around the programs that hold the NMS and
    the peak-scan kernels."""
    counts = pipe.timer.counts
    return (counts.get("perception_step", 0) - since[0],
            counts.get("pose_dispatch", 0) - since[1])


def check_replayed(pipe, calls_before, batches, since, what):
    """Every device-program call since ``calls_before`` (a copy of
    ``graph_calls``) replayed a graph, and each of ``batches`` batches
    called its perception and pose programs once."""
    calls = {k: pipe.graph_calls[k] - calls_before[k] for k in calls_before}
    if calls["eager"] or dispatched(pipe, since) != (batches, batches):
        raise AssertionError(f"{what}: device-program calls {calls}, "
                             f"perception and pose dispatches "
                             f"{dispatched(pipe, since)} over {batches} "
                             "batches")
    return calls


def kernel_bound_ms(m, h, w, k, factor=8):
    """Least time for the fused peak scan of m planes of h x w: each input
    read once and each output written once over HBM, or the FIR and
    comparison operations over the float32 rate, whichever is larger."""
    up_h, up_w = h * factor, w * factor
    # H FIR per (upsampled row, source column), W FIR per upsampled pixel:
    # 4 multiplies + 3 adds each; 4 neighbour compares + threshold.
    ops = m * (up_h * w * 7 + up_h * up_w * (7 + 5))
    nbytes = m * h * w * 4 + m * k * (2 * 4 + 4 + 1) + m
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nms_plain(*args, **kwargs):
    """``nms_fixed`` with the suppression's plain version, on any device."""
    from terran_tpu_torch.ops import nms

    kernel = nms.suppress
    nms.suppress = nms.suppress_plain
    try:
        return nms.nms_fixed(*args, **kwargs)
    finally:
        nms.suppress = kernel


def assert_same_nms(got, expected, label):
    """All five outputs of ``nms_fixed`` equal: dtype, shape and values,
    NaNs counted equal."""
    import torch

    names = ("boxes", "scores", "keep", "order", "overflow")
    for name, g, e in zip(names, got, expected):
        same = g.shape == e.shape and g.dtype == e.dtype
        if same and g.is_floating_point():
            same = bool(((g == e) | (torch.isnan(g) & torch.isnan(e))).all())
        elif same:
            same = torch.equal(g, e)
        if not same:
            raise AssertionError(f"NMS {label}: kernel and plain version "
                                 f"differ in {name}")


def random_boxes(rng, n, a, height, width):
    """(n, a, 4) boxes with corners on a height x width canvas and sides
    of 5-120 px, and (n, a) uniform scores."""
    import numpy as np

    xy = rng.uniform(0, 1, (n, a, 2)) * (width, height)
    wh = rng.uniform(5, 120, (n, a, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    return boxes, rng.uniform(0, 1, (n, a)).astype(np.float32)


def nms_tests(top_boxes, valid, keep, iou_threshold):
    """(N,) IoU tests that greedy NMS needs on these inputs: each kept
    candidate i against each later valid j that no survivor before i has
    suppressed. A valid j is tested by every survivor up to the first one
    that overlaps it, or by every survivor before it if none does."""
    import torch

    from terran_tpu_torch.ops.nms import iou_matrix

    n, k = keep.shape
    idx = torch.arange(k, device=keep.device)
    hits = (keep[:, :, None] & (idx[:, None] < idx[None, :])
            & (iou_matrix(top_boxes, top_boxes) > iou_threshold))
    # The last survivor to test j: its first suppressor, else j - 1.
    last = torch.where(hits, idx[None, :, None], k).amin(dim=1)
    last = torch.minimum(last, idx - 1)
    # kept_upto[:, m + 1] = survivors at or before m.
    kept_upto = torch.nn.functional.pad(keep.long().cumsum(dim=1), (1, 0))
    return (kept_upto.gather(1, last + 1) * valid).sum(dim=1)


def nms_bound_ms(top_boxes, valid, keep, iou_threshold):
    """Least time of the suppression on these inputs, the larger of: boxes
    (16 bytes) and valid flags (1) read once and the keep mask (1) written
    once over HBM; the areas and the IoU tests of :func:`nms_tests` over
    the float32 rate. Returns (ms, "bytes" or "operations")."""
    n, k = keep.shape
    tests = float(nms_tests(top_boxes, valid, keep, iou_threshold).sum())
    ops = tests * IOU_OPS + 3 * n * k
    nbytes = n * k * (16 + 1 + 1)
    t_ops, t_bytes = ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_iou_mask(top_boxes, iou_threshold):
    """The mask kernel alone against ``iou_mask_plain``, the packed bits of
    ``iou_matrix > threshold`` over j > i: every word the sweep reads (at
    or right of a row's own chunk) equal. Returns the nonzero words."""
    import torch

    from terran_tpu_torch.ops import nms

    got = nms.iou_mask(top_boxes, iou_threshold)
    expected = nms.iou_mask_plain(top_boxes, iou_threshold)
    idx = torch.arange(top_boxes.shape[1], device=top_boxes.device)
    read = (torch.arange(got.shape[2], device=got.device)[None, :]
            >= (idx // nms.WORD)[:, None])
    if got.shape != expected.shape or not torch.equal(
            torch.where(read, got, 0), expected):
        raise AssertionError("mask kernel and iou_mask_plain differ")
    return int(expected.ne(0).sum())


def decided_chunks(keep):
    """(N,) chunks of 64 candidates that the sweep kernel decides: those
    with an alive candidate, which are those holding a survivor, since the
    first alive candidate of a chunk always survives. The rest cost the
    sweep one barrier each."""
    import torch

    from terran_tpu_torch.ops.nms import WORD

    n, k = keep.shape
    padded = torch.nn.functional.pad(keep, (0, -k % WORD))
    return padded.view(n, -1, WORD).any(dim=2).sum(dim=1)


def nms_phase(detector, frames, rng, dev, card):
    """The NMS kernel against its plain version on the card, and its
    times; returns the kernel's entry fields, the largest difference of
    any output from its plain version, and the model's decoded (boxes,
    scores)."""
    import numpy as np
    import torch

    from terran_tpu_torch.models.retinaface import anchor_cell_meta
    from terran_tpu_torch.ops import nms

    h, w = DETECT_SHAPE
    boxes, scores = nms_phase_boxes(detector, frames, dev)
    if scores.shape[1] != ANCHORS:
        raise AssertionError(f"{scores.shape[1]} anchors, expected {ANCHORS}")
    cell_x = torch.from_numpy(anchor_cell_meta(h, w)[0]).to(dev)
    if int(cell_x.max()) != -(-w // 8) - 1:
        raise AssertionError("anchor cells do not cover the frame")

    def as_dev(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    rand_boxes, rand_scores = as_dev(*random_boxes(rng, 8, ANCHORS, h, w))
    big_boxes, big_scores = as_dev(*random_boxes(rng, 2, ANCHORS, h, w))
    plateau = torch.tensor([[[40.0, 40.0, 120.0, 140.0]]],
                           device=dev).expand(2, 600, 4).contiguous()
    nonfinite, nf_scores = random_boxes(rng, 4, 3000, h, w)
    nonfinite[:, ::7, 2] = np.inf
    nonfinite[:, 1::7, 0] = -np.inf
    nonfinite[:, 1::7, 2] = np.inf
    nonfinite[:, 2::7, 1] = np.nan
    nonfinite[:, 3::7] = (-np.inf, -np.inf, np.inf, np.inf)
    nonfinite, nf_scores = as_dev(nonfinite, nf_scores)
    small_boxes, small_scores = as_dev(*random_boxes(rng, 3, 100, h, w))
    # +inf scores sort first and are not valid: the first two chunks of
    # K=192 hold no valid candidate, so every survivor is in the last one.
    tail_boxes, tail_scores = as_dev(*random_boxes(rng, 2, 200, h, w))
    tail_scores[:, :128] = float("inf")
    cases = [
        ("random boxes N=8", rand_boxes, rand_scores, 0.5, 256),
        ("random boxes N=8 K=64", rand_boxes, rand_scores, 0.5, 64),
        ("random boxes N=8 K=65", rand_boxes, rand_scores, 0.5, 65),
        ("random boxes N=8 K=100", rand_boxes, rand_scores, 0.5, 100),
        ("random boxes N=8 K=4096", rand_boxes, rand_scores, 0.1, 4096),
        ("model boxes K=64 (the pipeline's)", boxes, scores, 0.5, 64),
        ("model boxes K=256", boxes, scores, 0.5, 256),
        ("model boxes K=512", boxes, scores, 0.5, 512),
        ("model boxes K=1024", boxes, scores, 0.5, 1024),
        ("random boxes N=2 K=2048", big_boxes, big_scores, 0.1, 2048),
        ("random boxes N=2 K=4096", big_boxes, big_scores, 0.1, 4096),
        ("tie plateau of identical boxes", plateau,
         torch.full((2, 600), 0.75, device=dev), 0.5, 256),
        ("inf and NaN boxes", nonfinite, nf_scores, 0.2, 1024),
        ("no candidate above threshold", rand_boxes, rand_scores * 0.4, 0.5,
         256),
        ("survivors only in the last chunk", tail_boxes, tail_scores, 0.1,
         192),
        ("top_k above A", small_boxes, small_scores, 0.1, 256),
        ("N=1", boxes[:1], scores[:1], 0.5, 256),
    ]
    max_abs_err = 0.0
    for label, b, sc, thr, k in cases:
        got = nms.nms_fixed(b, sc, 0.4, score_threshold=thr, top_k=k)
        expected = nms_plain(b, sc, 0.4, score_threshold=thr, top_k=k)
        torch.cuda.synchronize()
        for g, e in zip(got, expected):
            diff = (g.double() - e.double()).abs()
            # Equal infinities and NaNs differ by NaN; assert_same_nms
            # holds them equal.
            diff = diff[~torch.isnan(diff)]
            if diff.numel():
                max_abs_err = max(max_abs_err, float(diff.max()))
        assert_same_nms(got, expected, label)
        keep = got[2]
        if label.startswith("tie") and keep.sum(dim=1).tolist() != [1, 1]:
            raise AssertionError("tie plateau: expected one survivor each")
        if label.startswith("no candidate") and keep.any():
            raise AssertionError("a candidate survived below the threshold")
        if label.startswith("survivors only") and (
                keep[:, :128].any() or not keep[:, 128:].any(dim=1).all()):
            raise AssertionError("expected survivors in the last chunk only")
        log(f"NMS kernel == plain: {label} {tuple(b.shape)} K={k}: "
            f"{int(keep.sum())} kept, {int(got[4].sum())} overflowed")

    top = nms.nms_fixed(boxes, scores, 0.4, score_threshold=0.5, top_k=1024)
    pairs = check_iou_mask(top[0], 0.4)
    log(f"mask kernel == iou_mask_plain: model boxes K=1024: {pairs} "
        f"nonzero mask words")

    # Times at N=8 on the model's own pre-selected boxes.
    fields = {}
    for k in (PIPE_CONFIG["top_k"], 256, 1024):
        top_boxes, top_scores, keep, _, _ = nms.nms_fixed(
            boxes, scores, 0.4, score_threshold=0.5, top_k=k)
        valid = torch.isfinite(top_scores)
        ms = time_ms(lambda: nms.suppress(top_boxes, valid, 0.4))
        plain_ms = time_ms(lambda: nms.suppress_plain(top_boxes, valid, 0.4),
                           iters=3, warm=1)
        call_ms = time_ms(lambda: nms.nms_fixed(
            boxes, scores, 0.4, score_threshold=0.5, top_k=k))
        bound_ms, bound_by = nms_bound_ms(top_boxes, valid, keep, 0.4)
        decided = int(decided_chunks(keep).max())
        survivors = int(keep.sum(dim=1).max())
        log(f"NMS timing, N=8, K={k} ({card}): suppress (2 kernels) "
            f"{ms:.4f} ms, plain version {plain_ms:.4f} ms, whole nms_fixed "
            f"{call_ms:.4f} ms; {int(keep.sum())} kept, {survivors} in the "
            f"busiest image; bound {bound_ms:.6f} ms ({bound_by}); sweep "
            f"chain in the busiest image: {decided} of {-(-k // nms.WORD)} "
            f"chunks decided")
        fields[k] = {"ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "chain_steps": decided, "kept": int(keep.sum())}
    return fields, max_abs_err, (boxes, scores)


def nms_phase_boxes(detector, frames, dev):
    """(boxes (N, A, 4), scores (N, A)) of the detector's decode at the
    main shape, float32 on the card."""
    import torch

    from terran_tpu_torch.models.retinaface import (
        anchors_for_shape, decode_outputs,
    )

    resized, _ = detector_resize(detector, frames)
    with torch.inference_mode():
        outputs = detector.model(resized.to(detector.model.compute_dtype))
        anchors = torch.from_numpy(anchors_for_shape(*DETECT_SHAPE)).to(dev)
        scores, boxes, _ = decode_outputs(outputs, anchors)
    return boxes, scores


def detector_resize(detector, frames):
    """The detection task's resize of ``frames`` on the detector's card."""
    from terran_tpu_torch.utils.batching import resize_factory

    resize_in, _ = resize_factory(short_side=DETECT_SHAPE[0],
                                  device=detector.device)
    return resize_in(frames)


def timed_calls(fn):
    """(last result, warm-call seconds, median ms of TIMED_CALLS calls)."""
    import torch

    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start
    times = []
    for _ in range(TIMED_CALLS):
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    return out, warm_s, 1e3 * sorted(times)[len(times) // 2]


def synthetic_faces(rng, frames):
    """FACES_PER_FRAME faces for each of ``frames`` 1080p frames:
    ARCFACE_TEMPLATE scaled x2 at seeded spots inside the frame, as
    detections with int32 landmarks."""
    import numpy as np

    from terran_tpu_torch.ops.warp import ARCFACE_TEMPLATE

    faces = []
    for _ in range(frames):
        frame_faces = []
        for _ in range(FACES_PER_FRAME):
            x0 = rng.uniform(0, FRAME[1] - 224)
            y0 = rng.uniform(0, FRAME[0] - 224)
            lmk = ARCFACE_TEMPLATE * 2.0 + (x0, y0)
            frame_faces.append({
                "bbox": np.array([x0, y0, x0 + 224, y0 + 224], np.int32),
                "landmarks": np.around(lmk).astype(np.int32),
                "score": np.float32(0.99),
            })
        faces.append(frame_faces)
    return faces


def detection_phase(rf_params, frames, card, device=None):
    """The detection task API on ``frames``, bf16: times, escalations,
    faces and the result contract. Returns the NMS ``suppress`` calls
    (two kernel launches each)."""
    import numpy as np
    import torch

    from terran_tpu_torch.face import Detection
    from terran_tpu_torch.ops import nms

    detection = Detection(params=rf_params, device=device)
    if detection.model.model.compute_dtype != torch.bfloat16:
        raise AssertionError("the detection path must run bf16")
    nms.suppress.launches = 0
    faces, warm_s, det_ms = timed_calls(lambda: detection(frames))
    nms_calls = nms.suppress.launches
    if detection.device.type == "cuda" and nms_calls < 1 + TIMED_CALLS:
        raise AssertionError("the detection path did not launch the NMS "
                             "kernels")
    det_escalations = detection.model.escalation_count
    log(f"detection path ({card}): batch {len(frames)} x "
        f"{frames.shape[1]}x{frames.shape[2]}, short side "
        f"{DETECT_SHAPE[0]}, bf16: warm call {warm_s:.3f} s, "
        f"{det_ms:.2f} ms/batch median of {TIMED_CALLS} "
        f"({len(frames) * 1e3 / det_ms:.2f} frames/s); NMS suppress calls "
        f"{nms_calls} (2 kernels each); escalations {det_escalations} over "
        f"{1 + TIMED_CALLS} calls; faces per frame {[len(f) for f in faces]}")
    assert len(faces) == len(frames)
    for frame_faces in faces:
        scores = [face["score"] for face in frame_faces]
        if scores != sorted(scores, reverse=True):
            raise AssertionError("detection scores are not descending")
        for face in frame_faces:
            assert face["bbox"].shape == (4,)
            assert face["bbox"].dtype == np.int32
            assert face["landmarks"].shape == (5, 2)
            assert face["landmarks"].dtype == np.int32
            assert np.isfinite(face["score"])
    return nms_calls, det_ms


def recognition_phase(arc_params, frames, rng, card, device=None):
    """The recognition task API on ``frames`` with FACES_PER_FRAME
    synthetic faces a frame, bf16: time and the embeddings' contract."""
    import numpy as np
    import torch

    from terran_tpu_torch.face import Recognition

    recognition = Recognition(params=arc_params, device=device)
    if recognition.model.model.compute_dtype != torch.bfloat16:
        raise AssertionError("the recognition path must run bf16")
    face_lists = synthetic_faces(rng, len(frames))
    feats, warm_s, rec_ms = timed_calls(
        lambda: recognition(list(frames), face_lists))
    log(f"recognition path ({card}): {len(frames)} frames x "
        f"{FACES_PER_FRAME} faces, full FaceResNet100, bf16: warm call "
        f"{warm_s:.3f} s, {rec_ms:.2f} ms/batch median of {TIMED_CALLS} "
        f"({len(frames) * FACES_PER_FRAME * 1e3 / rec_ms:.1f} faces/s)")
    assert len(feats) == len(frames)
    for frame_feats in feats:
        assert frame_feats.shape == (FACES_PER_FRAME, 512)
        assert frame_feats.dtype == np.float32
        norms = np.linalg.norm(frame_feats, axis=1)
        if not np.allclose(norms, 1.0, rtol=1e-5):
            raise AssertionError(f"embeddings are not unit vectors: {norms}")
    return rec_ms


def face_float32_phase(rf_params, arc_params, rng, dev):
    """float32, TF32 off: RetinaFace and ArcFace forwards on the card
    against the CPU's on small inputs, and the detect step's keep masks
    equal."""
    import numpy as np
    import torch

    from terran_tpu_torch.face.detection import RetinaFaceDetector
    from terran_tpu_torch.face.recognition import ArcFaceRecognizer
    from terran_tpu_torch.models.retinaface import unpack_detections

    det = {d: RetinaFaceDetector(params=rf_params, device=d, top_k=1024,
                                 compute_dtype=torch.float32)
           for d in (dev, "cpu")}
    images = torch.as_tensor(rng.integers(0, 256, (2, 96, 128, 3)),
                             dtype=torch.uint8)
    with torch.inference_mode():
        ref = det["cpu"].model(images.float())
        got = det[dev].model(images.to(dev).float())
    # Heads reach ~10 with random weights; cuDNN and the CPU sum in other
    # orders: 2e-5 of the largest output.
    worst = 0.0
    for stride in (8, 16, 32):
        for name, g, r in zip(("cls", "bbox", "landmark"), got[stride],
                              ref[stride]):
            err = float((g.cpu() - r).abs().max())
            scale = max(1.0, float(r.abs().max()))
            if not err <= 2e-5 * scale:
                raise AssertionError(f"card vs CPU RetinaFace {name} "
                                     f"stride {stride}: max abs error {err}")
            worst = max(worst, err / scale)
    log(f"card vs CPU float32 RetinaFace heads: max abs error "
        f"{worst:.2e} of the largest output")
    packed = [unpack_detections(det[d]._detect_fn(96, 128)(
        images.to(det[d].device), 0.5).cpu().numpy()) for d in (dev, "cpu")]
    if not np.array_equal(packed[0][3], packed[1][3]):
        raise AssertionError("card vs CPU detect step: keep masks differ")
    log(f"card vs CPU float32 detect step: keep masks equal "
        f"({int(packed[0][3].sum())} kept of 2 x 1024)")

    rec = {d: ArcFaceRecognizer(params=arc_params, device=d,
                                compute_dtype=torch.float32)
           for d in (dev, "cpu")}
    crops = torch.as_tensor(rng.integers(0, 256, (2, 112, 112, 3)),
                            dtype=torch.float32)
    with torch.inference_mode():
        ref = rec["cpu"].model(crops)
        got = rec[dev].model(crops.to(dev)).cpu()
    # Features of ~50 in magnitude through 100 layers: 1e-5 relative.
    err = float((got - ref).abs().max())
    if not err <= 1e-5 * float(ref.abs().max()):
        raise AssertionError(f"card vs CPU ArcFace features: max abs error "
                             f"{err}")
    log(f"card vs CPU float32 ArcFace features: max abs error {err:.2e} "
        f"(largest feature {float(ref.abs().max()):.2f})")


def pipeline_kwargs(params, **overrides):
    det, rec, pose = params
    return dict(PIPE_CONFIG, det_params=det, rec_params=rec,
                pose_params=pose, **overrides)


def pipeline_batches():
    """PIPE_BATCHES seeded batches of BATCH 1080p frames."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    return [rng.integers(0, 255, (BATCH,) + FRAME + (3,), dtype=np.uint8)
            for _ in range(PIPE_BATCHES)]


def pipeline_phase(params, batches, card, task_ms):
    """The perception pipeline at bench.py's configuration, bf16: warmup,
    one batch, then PIPE_SWEEPS timed ``process_stream`` sweeps over
    ``batches``, every device-program call a replay and every batch's
    perception and pose programs called once (the kernels those replay
    are counted in phase 6, under the profiler); then
    an escalating run that must raise every escalation counter. Returns
    the pipeline's fields for the result lines, and the warm pipeline."""
    import torch

    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    pipe = PerceptionPipeline(**pipeline_kwargs(params, timer=timer))
    for model in (pipe.det_model, pipe.rec_model, pipe.pose_model):
        if model.compute_dtype != torch.bfloat16:
            raise AssertionError("the pipeline must run bf16")
    start = time.perf_counter()
    programs = pipe.warmup(BATCH, *FRAME)
    warm_s = time.perf_counter() - start
    out = pipe.process_batch(batches[0])
    check_pipeline_result(out, BATCH, PIPE_CONFIG)
    # Enqueueing a batch must not wait for the card, or process_stream
    # cannot overlap one batch's host stages with the next one's compute.
    frames_dev = pipe.put_frames(batches[0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        dispatched = pipe.dispatch_batch(frames_dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check_pipeline_result(pipe.finalize_batch(*dispatched), BATCH,
                          PIPE_CONFIG)
    for _ in pipe.process_stream(batches[:2], depth=PIPE_DEPTH):
        pass  # ramps the uploader thread and queues, as bench.py does

    timer.reset()
    uploaded = pipe.upload_bytes
    graph_calls = dict(pipe.graph_calls)
    fps = []
    for _ in range(PIPE_SWEEPS):
        start = time.perf_counter()
        outs = list(pipe.process_stream(batches, depth=PIPE_DEPTH))
        fps.append(BATCH * PIPE_BATCHES / (time.perf_counter() - start))
        for out in outs:
            check_pipeline_result(out, BATCH, PIPE_CONFIG)
    swept = PIPE_SWEEPS * PIPE_BATCHES
    upload_per_frame = (pipe.upload_bytes - uploaded) / (swept * BATCH)
    graph_calls = check_replayed(pipe, graph_calls, swept, (0, 0),
                                 "the pipeline's sweeps")
    fps_median = sorted(fps)[len(fps) // 2]
    batch_ms = BATCH * 1e3 / fps_median
    summary = timer.summary()
    log(f"pipeline ({card}): {PIPE_SWEEPS} process_stream sweeps of "
        f"{PIPE_BATCHES} batches x {BATCH} x {FRAME[0]}x{FRAME[1]}, depth "
        f"{PIPE_DEPTH}, {PIPE_CONFIG}, bf16: warmup {programs} programs in "
        f"{warm_s:.3f} s; frames/s per sweep "
        + ", ".join(f"{f:.2f}" for f in fps)
        + f"; median {fps_median:.2f} frames/s = {batch_ms:.2f} ms/batch, "
        f"against {sum(task_ms.values()):.2f} ms/batch for the three task "
        f"APIs in this run ({', '.join(f'{k} {v:.2f}' for k, v in task_ms.items())}"
        f"); device-program calls over the sweeps {graph_calls}")
    log("pipeline stage timer (host wall time, the sweeps): "
        + json.dumps(summary))

    esc = PerceptionPipeline(**pipeline_kwargs(params, max_escalations=2))
    esc_out = esc.process_batch(batches[1][:2])
    if min(esc.escalations.values()) < 1:
        raise AssertionError(f"max_escalations=2: not every escalation "
                             f"fired: {esc.escalations}")
    log(f"pipeline max_escalations=2 on 2 frames: escalations "
        f"{esc.escalations}, boxes {esc_out['boxes'].shape}, embeddings "
        f"{esc_out['embeddings'].shape}")
    return {"fps": fps, "fps_median": fps_median, "batch_ms": batch_ms,
            "warmup_programs": programs, "warmup_s": warm_s,
            "batches": PIPE_BATCHES, "graph_calls": graph_calls,
            "stages": summary,
            "task_ms": task_ms, "escalations": esc.escalations,
            "upload_bytes_per_frame": upload_per_frame}, pipe


# BODY_25 (models/body25.py) at its published widths and input: pose
# short side 368, so a 1080p frame's 46x81 field, 12x11 = 132 tiles a
# plane, 25 parts read in place from the 78-channel output.
BODY25_SIDE = 368
BODY25_FIELD = (46, 81)
BODY25_KS = (16, 128, 512)


def body25_peaks_phase(pipe, batch, card):
    """The fused peak kernel on BODY_25's own view against its plain
    version, exact: the strided [..., :25] of a (BATCH, 46, 81, 78) field
    (a noise field's 3x3 box blur, so that peaks are a few hundred a
    plane and some near ties) and of the model's own output on ``batch``
    at the pipeline's pose resize, at K = 16 (the pipeline's), 128 and
    512, which holds every peak of the noise field; the call at K=16
    timed beside its bound. Returns its fields."""
    import torch

    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops.pose_decode import BODY_25, normalize_images
    from terran_tpu_torch.ops.resize import resize_bilinear_u8, resized_shape

    dev = pipe.device
    parts = BODY_25.parts
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    field = torch.randn((BATCH, 78) + BODY25_FIELD, generator=gen,
                        device=dev)
    field = torch.nn.functional.avg_pool2d(field, 3, stride=1, padding=1)
    field = field.permute(0, 2, 3, 1).contiguous()
    h, w = BODY25_FIELD
    ph, pw, _ = resized_shape(*FRAME, BODY25_SIDE)
    resized = resize_bilinear_u8(torch.as_tensor(batch, device=dev), ph, pw)
    with torch.inference_mode():
        pafs, heat = pipe.pose_model(normalize_images(
            resized, pipe.pose_model.input_scale).to(
                pipe.pose_model.compute_dtype))
        model_out = torch.cat([heat, pafs], dim=-1).float()
    if tuple(model_out.shape) != (BATCH, h, w, 78):
        raise AssertionError(f"BODY_25's output at the pose resize is "
                             f"{tuple(model_out.shape)}, expected "
                             f"{(BATCH, h, w, 78)}")
    if fp.num_tiles(h, w) != 132:
        raise AssertionError(f"{fp.num_tiles(h, w)} tiles on {h}x{w}")
    fields = {}
    for label, out in (("box-blurred noise", field),
                       ("model output", model_out)):
        view = out[..., :parts]  # in place: 78 floats between pixels
        if view.is_contiguous() or view.stride(-2) != 78:
            raise AssertionError("the 25-part case must pass the view")
        for k in BODY25_KS:
            got = fp.find_peaks_fused(view, 0.1, k)
            expected = fp.find_peaks_fused_plain(view, 0.1, k)
            torch.cuda.synchronize()
            assert_same(got, expected, f"BODY_25 {label} K={k}")
            if (got[0].shape != (BATCH, parts, k, 2)
                    or not bool(got[2].any())
                    or (out is field and k == 512 and bool(got[3].any()))):
                raise AssertionError(f"BODY_25 {label} K={k}: "
                                     f"{tuple(got[0].shape)}, "
                                     f"{int(got[2].sum())} peaks")
            fields[f"{label} K={k}"] = {
                "peaks": int(got[2].sum()),
                "overflowed_parts": int(got[3].sum())}
            log(f"kernel == plain: BODY_25 {label}, strided [..., :25] of "
                f"{tuple(out.shape)} K={k}: {int(got[2].sum())} peaks "
                f"kept, {int(got[3].sum())} parts overflowed")
    view = model_out[..., :parts]
    ms = time_ms(lambda: fp.find_peaks_fused(view, 0.1, BODY25_KS[0]))
    bound, by = kernel_bound_ms(BATCH * parts, h, w, BODY25_KS[0])
    log(f"timing at BODY_25's shape ({card}): find_peaks_fused "
        f"{ms:.4f} ms a call at K={BODY25_KS[0]} on {BATCH * parts} planes "
        f"of {h}x{w}; bound {bound:.5f} ms ({by})")
    return {"cases": fields, "ms_k16": ms, "bound_ms_k16": bound,
            "bound_by_k16": by}


def body25_phase(rf_params, batches, card):
    """``PerceptionPipeline(pose='body25')`` at published widths, bf16,
    the ``body25-pose-offline-1080p`` cell's settings (PIPE_CONFIG, pose
    short side 368, no recognizer), with weights drawn from the
    benchmark's reference table: first ``process_stream`` over
    ``batches`` before ``warmup``, every program eager, with the kernels'
    launch counts set to 0 just before it: each pair exactly 2 launches a
    batch, peaks found, poses of 25 keypoints; then the peak kernel on
    BODY_25's view (``body25_peaks_phase``); then ``warmup`` and
    PIPE_SWEEPS timed sweeps, every program call a replay (their kernels
    counted in phase 6). Returns its fields and the warm pipeline."""
    import numpy as np
    import torch

    import terran_tpu_torch.pipeline as program
    from terran_tpu_torch.models import body25
    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops import nms
    from terran_tpu_torch.ops.pose_decode import BODY_25
    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.utils.convert import convert_body25
    from terran_tpu_torch.utils.profiling import StageTimer
    from torch_body25_weights import body25_state_dict

    sd = body25_state_dict(np.random.default_rng(SEED + 5),
                           body25.TRUNK_WIDTHS, body25.STAGE_WIDTHS)
    timer = StageTimer()
    pipe = PerceptionPipeline(**dict(
        PIPE_CONFIG, det_params=rf_params, pose_params=convert_body25(sd),
        pose="body25", with_embeddings=False, pose_short_side=BODY25_SIDE,
        timer=timer))
    if (not isinstance(pipe.pose_model, body25.Body25Model)
            or pipe.pose_model.compute_dtype != torch.bfloat16
            or pipe.skeleton is not BODY_25):
        raise AssertionError("the BODY_25 pipeline must run Body25Model "
                             "in bf16 with BODY_25's skeleton")

    def check(outs):
        for out in outs:
            if len(out["poses"]) != BATCH:
                raise AssertionError("a BODY_25 batch lost frames")
            for people in out["poses"]:
                for person in people:
                    if person["keypoints"].shape != (BODY_25.parts, 3):
                        raise AssertionError("a BODY_25 pose without 25 "
                                             "keypoints")

    tables = []
    original = recorded_assembly(tables)
    try:
        fp.find_peaks_fused.launches = 0
        nms.suppress.launches = 0
        calls = dict(pipe.graph_calls)
        eager = []
        epilogues, expected = counted_epilogues(pipe, lambda: eager.extend(
            pipe.process_stream(batches, depth=PIPE_DEPTH)))
    finally:
        program.assemble_humans = original
    launches = {"fused_peaks": fp.find_peaks_fused.launches,
                "nms": 2 * nms.suppress.launches}
    eager_calls = pipe.graph_calls["eager"] - calls["eager"]
    check(eager)
    if eager_calls < 2 * len(batches) or pipe.graph_calls["replayed"]:
        raise AssertionError(f"BODY_25 before warmup: {pipe.graph_calls}")
    check_launches(launches, len(batches), "the BODY_25 pipeline (eager)")
    if len(tables) != BATCH * len(batches) or any(
            t[0].shape[0] != BODY_25.parts for t in tables):
        raise AssertionError("the assembly did not get 25-part tables for "
                             "every frame")
    valid = sum(int(t[2].sum()) for t in tables)
    humans = sum(len(p) for out in eager for p in out["poses"])
    if not valid:
        raise AssertionError("BODY_25 found no peak")
    log(f"BODY_25 pipeline before warmup ({card}): {len(batches)} batches "
        f"of {BATCH} eager, launches per batch "
        + ", ".join(f"{k} {v / len(batches):g}" for k, v in launches.items())
        + f"; {valid / (BATCH * len(batches) * BODY_25.parts):.2f} valid "
        f"peaks a part a frame, {humans} humans")

    if sum(epilogues.values()) != expected:
        raise AssertionError(f"BODY_25 before warmup: conv epilogue "
                             f"launches {epilogues}, expected {expected}")
    per_call = epilogue_convs(pipe.pose_model)
    epilogue = epilogue_timing(recorded_epilogues(
        lambda: pipe.process_batch(batches[0])), card)
    log(f"BODY_25 conv epilogue ({card}): {sum(epilogues.values())} "
        f"launches over the {len(batches)} eager batches (expected "
        f"{expected}; {per_call} a BODY_25 call), by mode {epilogues}; one "
        f"batch's launches rebuilt with NaN, +-inf and -0: kernel equal to "
        f"the plain version bit for bit {epilogue['exact']} (largest "
        f"difference {epilogue['max_abs_err']}), in one graph: kernel "
        f"{epilogue['kernel_ms']:.4f} device ms a batch, bound "
        f"{epilogue['bound_ms']:.4f} ms ({epilogue['bound_share_pct']:.1f}% "
        f"of it), plain {epilogue['plain_ms']:.4f} ms, the eager chain "
        f"{epilogue['eager_chain_ms']:.4f} ms; largest call "
        f"{epilogue['largest']}")

    peaks = body25_peaks_phase(pipe, batches[0], card)

    start = time.perf_counter()
    programs = pipe.warmup(BATCH, *FRAME)
    warm_s = time.perf_counter() - start
    for _ in pipe.process_stream(batches[:2], depth=PIPE_DEPTH):
        pass
    timer.reset()
    graph_calls = dict(pipe.graph_calls)
    fps = []
    for _ in range(PIPE_SWEEPS):
        start = time.perf_counter()
        outs = list(pipe.process_stream(batches, depth=PIPE_DEPTH))
        fps.append(BATCH * PIPE_BATCHES / (time.perf_counter() - start))
        check(outs)
    swept = PIPE_SWEEPS * PIPE_BATCHES
    graph_calls = check_replayed(pipe, graph_calls, swept, (0, 0),
                                 "the BODY_25 pipeline's sweeps")
    fps_median = sorted(fps)[len(fps) // 2]
    pose_ms = 1e3 * timer.times["pose_device"] / timer.counts["pose_device"]
    log(f"BODY_25 pipeline ({card}): {PIPE_SWEEPS} process_stream sweeps "
        f"of {PIPE_BATCHES} batches x {BATCH} x {FRAME[0]}x{FRAME[1]}, "
        f"pose short side {BODY25_SIDE}, bf16: warmup {programs} programs "
        f"in {warm_s:.3f} s; frames/s per sweep "
        + ", ".join(f"{f:.2f}" for f in fps)
        + f"; median {fps_median:.2f}; pose_device {pose_ms:.3f} ms a "
        f"call; device-program calls over the sweeps {graph_calls}")
    return {"eager_launches_per_batch": {
                k: v / len(batches) for k, v in launches.items()},
            "valid_peaks_per_part_frame":
                valid / (BATCH * len(batches) * BODY_25.parts),
            "humans": humans, "peaks": peaks, "fps": fps,
            "conv_epilogue": dict(epilogue, launches=epilogues,
                                  expected=expected,
                                  per_body25_call=per_call),
            "fps_median": fps_median, "pose_device_ms": pose_ms,
            "warmup_programs": programs, "warmup_s": warm_s,
            "batches": PIPE_BATCHES, "graph_calls": graph_calls}, pipe


def recorded_assembly(tables):
    """Install a wrapper on the pipeline's ``assemble_humans`` that appends
    copies of every peak and limb table it is handed to ``tables``.
    Returns the original, to put back."""
    import numpy as np

    import terran_tpu_torch.pipeline as program

    original = program.assemble_humans

    def recording(*args, **kwargs):
        tables.append([np.array(a) for a in args])
        return original(*args, **kwargs)

    program.assemble_humans = recording
    return original


def graphs_phase(params, card):
    """The pipeline's CUDA graphs against its eager launches, bf16, bit for
    bit: ``process_stream(depth=PIPE_DEPTH)`` over GRAPH_BATCHES distinct
    seeded 1080p batches, once replaying what ``warmup`` captured and once
    down the cached eager closures (the same pipeline, its graph cache set
    aside). Every yielded output and pose and every peak and limb table
    handed to the pose assembly must be equal, and every call of the first
    run must replay. Two pipelines: bench.py's configuration, and one at
    ``top_k`` GRAPH_TOP_K with its keypoint threshold set before warmup
    from an eager pass (above each part's 9th peak), so that its embed and
    limb programs run at buckets below their maximum. Then the fused
    embed and fused limbs programs, one batch each way."""
    import numpy as np
    import torch

    import terran_tpu_torch.pipeline as program
    from terran_tpu_torch.pipeline import PerceptionPipeline

    rng = np.random.default_rng(SEED + 5)
    batches = [rng.integers(0, 255, (BATCH,) + FRAME + (3,), dtype=np.uint8)
               for _ in range(GRAPH_BATCHES)]

    def keypoint_threshold(pipe):
        """Just above the 9th peak's score of the fullest part: every part
        then keeps at most 8 peaks, below the 16 of max_peaks."""
        detect_pose = pipe._pose_detect_fn(*FRAME)
        with torch.inference_mode():
            peaks = [detect_pose(pipe.put_frames(b))[0].cpu().numpy()
                     for b in batches]
        scores = np.concatenate([p[..., 2] for p in peaks])
        valid = np.concatenate([p[..., 3] > 0.5 for p in peaks])
        ranked = -np.sort(-np.where(valid, scores, -np.inf), axis=-1)
        ninth = ranked[..., 8].max()
        if not np.isfinite(ninth):
            return None  # no part has 9 peaks
        return float(np.nextafter(np.float32(ninth), np.float32(np.inf)))

    def both_ways(pipe, run):
        tables = []
        original = recorded_assembly(tables)
        try:
            start = dict(pipe.graph_calls)
            got = run()
            calls = {k: pipe.graph_calls[k] - start[k] for k in start}
            got_tables, tables[:] = list(tables), []
            graphs, pipe._graphs = pipe._graphs, {}
            try:
                expected = run()
            finally:
                pipe._graphs = graphs
        finally:
            program.assemble_humans = original
        if calls["eager"] or not calls["replayed"]:
            raise AssertionError(f"graphs: device-program calls {calls}")
        for i, (g, e) in enumerate(zip(got, expected)):
            assert_same_pipeline(g, e, f"graphs: batch {i}, replayed vs "
                                       "eager")
        if len(got_tables) != len(tables) or not got_tables:
            raise AssertionError(f"graphs: {len(got_tables)} and "
                                 f"{len(tables)} assemblies")
        for i, (g, e) in enumerate(zip(got_tables, tables)):
            for name, a, b in zip(("coords", "scores", "valid", "reg",
                                   "accept"), g, e):
                if a.shape != b.shape or not np.array_equal(a, b):
                    raise AssertionError(f"graphs: frame {i}: {name} "
                                         "differs, replayed vs eager")
        return got, got_tables, calls

    def stream(pipe):
        return lambda: list(pipe.process_stream(batches, depth=PIPE_DEPTH))

    fields = {}
    main = PerceptionPipeline(**pipeline_kwargs(params))
    main.warmup(BATCH, *FRAME)
    out, tables, calls = both_ways(main, stream(main))
    fields["main"] = {"graphs": len(main._graphs), "calls": calls,
                      "limb_buckets": sorted({t[3].shape[-1]
                                              for t in tables})}
    del main

    small = PerceptionPipeline(**pipeline_kwargs(params, top_k=GRAPH_TOP_K))
    threshold = keypoint_threshold(small)
    if threshold is not None:
        small.keypoint_threshold = threshold
    small.warmup(BATCH, *FRAME)
    out, tables, calls = both_ways(small, stream(small))
    embed_buckets = set()
    for o in out:
        occupied = int((o["mask"] * np.arange(1, o["mask"].shape[1] + 1))
                       .max())
        if occupied:
            embed_buckets.add(small._select_embed_bucket(occupied,
                                                         small.max_faces))
    limb_buckets = sorted({t[3].shape[-1] for t in tables})
    if (not embed_buckets or max(embed_buckets) >= small.max_faces
            or not limb_buckets or max(limb_buckets) >= small.max_peaks):
        raise AssertionError(f"graphs: embed buckets {embed_buckets} of "
                             f"{small.max_faces}, limb buckets "
                             f"{limb_buckets} of {small.max_peaks}")
    fields["buckets"] = {"graphs": len(small._graphs), "calls": calls,
                         "top_k": GRAPH_TOP_K,
                         "keypoint_threshold": threshold,
                         "embed_buckets": sorted(embed_buckets),
                         "limb_buckets": limb_buckets}
    del small

    fused = PerceptionPipeline(**pipeline_kwargs(
        params, embed_dispatch="fused", limb_dispatch="fused"))
    fused.warmup(BATCH, *FRAME)
    _, _, calls = both_ways(fused, lambda: [fused.process_batch(batches[0])])
    fields["fused"] = {"graphs": len(fused._graphs), "calls": calls}
    del fused
    torch.cuda.synchronize()
    log(f"graphs ({card}): process_stream(depth={PIPE_DEPTH}) over "
        f"{GRAPH_BATCHES} distinct batches x {BATCH} x {FRAME[0]}x{FRAME[1]}, "
        f"bf16, replayed CUDA graphs equal to the eager launches bit for bit "
        f"(outputs, poses, peak and limb tables): bench.py's configuration "
        f"{fields['main']}; top_k {GRAPH_TOP_K} {fields['buckets']}; fused "
        f"embed and limbs, one batch, {fields['fused']}")
    return fields


def epilogue_convs(model):
    """The epilogues one forward of ``model`` launches: one for each
    floating-point conv and each standalone affine (FaceResNet100's
    ``pre`` and ``head_pre``)."""
    from torch import nn

    from terran_tpu_torch.models.layers import Affine

    return sum(isinstance(m, (nn.Conv2d, Affine)) for m in model.modules())


def counted_epilogues(pipe, run):
    """(conv_epilogue launches by mode, the launches expected) of ``run()``
    on ``pipe``: each call of each of its models, counted by a forward
    hook, times that model's :func:`epilogue_convs`."""
    import collections

    import torch

    from terran_tpu_torch.ops import conv_epilogue as ce

    models = [m for m in (pipe.det_model, pipe.rec_model, pipe.pose_model)
              if m is not None]
    calls = collections.Counter()
    hooks = [m.register_forward_pre_hook(
        lambda module, args: calls.update([id(module)])) for m in models]
    ce.conv_epilogue.launches.clear()
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for hook in hooks:
            hook.remove()
    return dict(ce.conv_epilogue.launches), sum(
        calls[id(m)] * epilogue_convs(m) for m in models)


def recorded_epilogues(run):
    """(shape, strides, dtype, scale?, bias?, relu, alpha?, residual?) of
    every conv_epilogue launch of ``run()``, in order."""
    from terran_tpu_torch.ops import conv_epilogue as ce

    calls = []
    kernel = ce.conv_epilogue_kernel

    def recording(x, bias, scale, relu, alpha, residual, inplace):
        calls.append((tuple(x.shape), x.stride(), x.dtype, scale is not None,
                      bias is not None, relu, alpha is not None,
                      residual is not None))
        return kernel(x, bias, scale, relu, alpha, residual, inplace)

    ce.conv_epilogue_kernel = recording
    try:
        run()
    finally:
        ce.conv_epilogue_kernel = kernel
    return calls


def captured(fn):
    """``fn`` captured in a CUDA graph after one eager run on the capture
    stream."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def same_bits(got, expected):
    """(equal, largest absolute difference) of two float tensors of one
    dtype, shape and layout: equal where every element has the same bits,
    a NaN matching any NaN; the difference over the elements finite in
    both."""
    import torch

    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if (got.dtype, got.shape, got.stride()) != (
            expected.dtype, expected.shape, expected.stride()):
        return False, float("inf")
    nan = got.isnan()
    equal = (torch.equal(nan, expected.isnan())
             and bool(((got.view(ints[got.dtype])
                        == expected.view(ints[got.dtype])) | nan).all()))
    finite = got.isfinite() & expected.isfinite()
    diff = (got.float() - expected.float()).abs()[finite]
    return equal, float(diff.max()) if diff.numel() else 0.0


def with_specials(t, gen, count=64):
    """``t`` with NaN, +inf, -inf and -0 at ``count`` seeded places of its
    memory and at its last 8 elements (the grid-stride loop's tail), in
    place; returns it."""
    import torch

    flat = t.as_strided((t.numel(),), (1,))
    places = torch.cat([
        torch.randint(t.numel(), (count,), generator=gen, device=t.device),
        torch.arange(max(t.numel() - 8, 0), t.numel(), device=t.device)])
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             -0.0], dtype=t.dtype, device=t.device)
    flat[places] = specials[torch.arange(places.numel(),
                                         device=t.device) % 4]
    return t


def epilogue_timing(calls, card, reps=10):
    """The recorded epilogues ``calls`` of one batch, rebuilt on seeded
    tensors of their shapes, strides and dtypes, with NaN, +-inf and -0
    among each output's and residual's values (:func:`with_specials`).
    First every case's kernel result, out of place and in place on a
    clone, equal bit for bit to the plain version's (raises otherwise).
    Then each way in one CUDA graph, all three reading the same inputs:
    the kernel out of place, the plain version, and the eager chain the
    models ran before (``x * scale + bias``, the activation, the residual
    add, each op in the dtype). Device ms a replay by CUDA events over
    ``reps`` replays (no profiler: it stays attached to the process and
    loses later phases' records); the byte bound: every output read and
    written once and every residual read once at PEAK_BYTES; and the
    largest call alone, timed and bounded. Returns the fields."""
    import torch

    from terran_tpu_torch.ops import conv_epilogue as ce

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def seeded(shape, stride, dtype, scale=1.0):
        t = torch.empty_strided(shape, stride, dtype=torch.float32,
                                device=dev)
        return (t.normal_(generator=gen) * scale).to(dtype)

    def vector(c, dtype, lo, hi):
        return (torch.rand(c, generator=gen, device=dev) * (hi - lo)
                + lo).to(dtype)

    cases, nbytes = [], 0
    for shape, stride, dtype, scale, bias, relu, alpha, res in calls:
        c = shape[1]
        x = with_specials(seeded(shape, stride, dtype), gen)
        cases.append((x, {
            "bias": vector(c, dtype, -0.1, 0.1) if bias else None,
            "scale": vector(c, dtype, 0.5, 1.0) if scale else None,
            "relu": relu,
            "alpha": vector(c, dtype, 0.0, 0.3) if alpha else None,
            "residual": with_specials(seeded(shape, stride, dtype, 0.01),
                                      gen) if res else None,
        }))
        nbytes += x.numel() * x.element_size() * (3 if res else 2)

    exact, max_abs_err = True, 0.0
    for i, (x, kw) in enumerate(cases):
        want = ce.conv_epilogue_plain(x, **kw)
        for inplace in (False, True):
            got = ce.conv_epilogue_kernel(x.clone() if inplace else x,
                                          inplace=inplace, **kw)
            equal, err = same_bits(got, want)
            exact, max_abs_err = exact and equal, max(max_abs_err, err)
            if not equal:
                raise AssertionError(
                    f"conv epilogue call {i} ({tuple(x.shape)}, "
                    f"{x.stride()}, {x.dtype}, {ce.mode(**kw)}, "
                    f"{'in place' if inplace else 'out of place'}): the "
                    f"kernel differs from the plain version (largest "
                    f"difference {err})")
        del want, got

    def eager_chain(x, bias, scale, relu, alpha, residual):
        def ch(v):
            return v.reshape(1, -1, 1, 1)

        if scale is not None:
            x = x * ch(scale)
        if bias is not None:
            x = x + ch(bias)
        if relu:
            x = torch.relu(x)
        elif alpha is not None:
            x = torch.where(x >= 0, x, x * ch(alpha))
        return x if residual is None else x + residual

    ways = {
        "kernel": lambda: [ce.conv_epilogue_kernel(x, **kw)
                           for x, kw in cases],
        "plain": lambda: [ce.conv_epilogue_plain(x, **kw)
                          for x, kw in cases],
        "eager_chain": lambda: [eager_chain(x, **kw) for x, kw in cases],
    }
    ms = {}
    for name, fn in ways.items():
        graph = captured(fn)
        ms[name] = time_ms(graph.replay, iters=reps, warm=2)
        del graph
        torch.cuda.synchronize()
    bound_ms = 1e3 * nbytes / PEAK_BYTES
    big_x, big_kw = max(cases, key=lambda case: case[0].numel()
                        * (3 if case[1]["residual"] is not None else 2))
    big_bytes = big_x.numel() * big_x.element_size() * (
        3 if big_kw["residual"] is not None else 2)
    graph = captured(lambda: ce.conv_epilogue_kernel(big_x, **big_kw))
    big_ms = time_ms(graph.replay)
    del graph
    big_bound = 1e3 * big_bytes / PEAK_BYTES
    fields = {
        "launches": len(cases), "exact": exact, "max_abs_err": max_abs_err,
        "bytes": nbytes, "bound_ms": bound_ms,
        "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
        "eager_chain_ms": ms["eager_chain"],
        "bound_share_pct": 100 * bound_ms / ms["kernel"],
        "largest": {"shape": list(big_x.shape), "dtype": str(big_x.dtype),
                    "mode": ce.mode(**big_kw),
                    "ms": big_ms, "bound_ms": big_bound,
                    "bound_share_pct": 100 * big_bound / big_ms},
        "card": card,
    }
    del cases
    torch.cuda.empty_cache()
    return fields


def conv_epilogue_phase(params, batches, card):
    """The conv epilogue on the main path, bf16: one eager
    ``process_batch`` of a fresh pipeline at bench.py's configuration
    (RetinaFace, FaceResNet100, OpenPose, before any warmup) launches
    conv_epilogue exactly once for each floating-point conv and standalone
    affine of each model call; then those launches rebuilt, checked bit
    for bit against the plain version and timed against their byte bound
    (:func:`epilogue_timing`). Returns the fields."""
    import torch

    from terran_tpu_torch.pipeline import PerceptionPipeline

    pipe = PerceptionPipeline(**pipeline_kwargs(params))
    pipe.process_batch(batches[0])  # cuDNN's and the kernels' first use
    per_call = {type(m).__name__: epilogue_convs(m)
                for m in (pipe.det_model, pipe.rec_model, pipe.pose_model)}
    launched, expected = counted_epilogues(
        pipe, lambda: pipe.process_batch(batches[1]))
    if sum(launched.values()) != expected:
        raise AssertionError(f"conv epilogue: {launched} launches over one "
                             f"eager batch, expected {expected}, one a conv "
                             "and standalone affine of each model call")
    calls = recorded_epilogues(lambda: pipe.process_batch(batches[1]))
    del pipe
    torch.cuda.synchronize()
    timing = epilogue_timing(calls, card)
    log(f"conv epilogue ({card}): one eager pipeline batch launched it "
        f"{sum(launched.values())} times (expected {expected}; a call of "
        f"each model: {per_call}), by mode {launched}; "
        f"those launches rebuilt with NaN, +-inf and -0: kernel equal to the "
        f"plain version bit for bit {timing['exact']} (largest difference "
        f"{timing['max_abs_err']}), replayed in one graph: kernel "
        f"{timing['kernel_ms']:.4f} device ms a batch, bound "
        f"{timing['bound_ms']:.4f} ms "
        f"({timing['bytes'] / 1e9:.3f} GB at 3.35 TB/s, "
        f"{timing['bound_share_pct']:.1f}% of it), plain "
        f"{timing['plain_ms']:.4f} ms, the eager chain "
        f"{timing['eager_chain_ms']:.4f} ms; largest call "
        f"{timing['largest']}")
    return {"launches": launched, "expected": expected,
            "per_model_call": per_call, **timing}


def check_pipeline_result(out, n, config):
    """The pipeline's result contract at its configuration, no escalation:
    int32 boxes (n, top_k, 4), unit or zero embeddings (n, max_faces,
    512), n pose lists of in-frame keypoints."""
    import numpy as np

    k, faces = config["top_k"], config["max_faces"]
    if out["boxes"].shape != (n, k, 4) or out["boxes"].dtype != np.int32:
        raise AssertionError(f"boxes {out['boxes'].shape} "
                             f"{out['boxes'].dtype}")
    if out["landmarks"].shape != (n, k, 5, 2):
        raise AssertionError(f"landmarks {out['landmarks'].shape}")
    emb, mask = out["embeddings"], out["embeddings_mask"]
    if emb.shape != (n, faces, 512) or mask.shape != (n, faces):
        raise AssertionError(f"embeddings {emb.shape}")
    norms = np.linalg.norm(emb, axis=-1)
    if not (np.allclose(norms[mask], 1.0, rtol=1e-3)
            and (norms[~mask] == 0).all()):
        raise AssertionError("embeddings are not unit vectors where valid "
                             "and zero elsewhere")
    if not np.isfinite(out["scores"][out["mask"]]).all():
        raise AssertionError("non-finite scores of kept faces")
    if len(out["poses"]) != n:
        raise AssertionError(f"{len(out['poses'])} pose lists for {n} frames")
    for people in out["poses"]:
        for person in people:
            kp = person["keypoints"]
            if kp.shape != (18, 3) or kp.dtype != np.int32:
                raise AssertionError(f"keypoints {kp.shape} {kp.dtype}")


def pipeline_float32_phase(params, rng, dev, card):
    """float32, TF32 off, deterministic cuDNN: ``process_stream`` equals
    ``process_batch`` on the card, and the card's pipeline agrees with a
    CPU pipeline on a small input. Tolerances: keep masks, overflow flags
    and embedding masks equal; kept boxes and landmarks within one count;
    kept scores within 1e-4; embeddings at cosine > 0.999; the pose peak
    tables (the peak kernels' output) matched within one upsampled pixel
    and 1e-4 of score, with at most 2% of the peaks unmatched (a local
    maximum whose neighbour differs by float32 rounding can move), and
    the same humans with the same keypoints."""
    import numpy as np
    import torch

    from terran_tpu_torch.pipeline import PerceptionPipeline

    pipe = PerceptionPipeline(**pipeline_kwargs(
        params, compute_dtype=torch.float32))
    batches = [rng.integers(0, 255, (2,) + FRAME + (3,), dtype=np.uint8)
               for _ in range(3)]
    streamed = list(pipe.process_stream(batches, depth=PIPE_DEPTH))
    for frames, got in zip(batches, streamed):
        expected = pipe.process_batch(frames)
        for key, value in expected.items():
            if key == "poses":
                same = [[p["keypoints"].tolist() for p in f] for f in value
                        ] == [[p["keypoints"].tolist() for p in f]
                              for f in got[key]]
            else:
                same = np.array_equal(got[key], value)
            if not same:
                raise AssertionError(f"process_stream and process_batch "
                                     f"differ in {key}")
    log(f"pipeline float32 on the card: process_stream == process_batch on "
        f"3 batches x 2 x {FRAME[0]}x{FRAME[1]} (every output, "
        f"{sum(int(o['mask'].sum()) for o in streamed)} faces)")

    small = dict(top_k=16, max_faces=4, max_peaks=8, det_short_side=96,
                 pose_short_side=96, compute_dtype=torch.float32)
    pipes = {d: PerceptionPipeline(**pipeline_kwargs(params, device=d,
                                                     **small))
             for d in (dev, "cpu")}
    frames = rng.integers(0, 255, (2, 96, 128, 3), dtype=np.uint8)
    got, ref = (pipes[d].process_batch(frames) for d in (dev, "cpu"))
    for key in ("mask", "det_overflow", "embeddings_mask", "pose_overflow"):
        if not np.array_equal(got[key], ref[key]):
            raise AssertionError(f"card vs CPU pipeline: {key} differs")
    mask, valid = ref["mask"], ref["embeddings_mask"]
    box_err = max(int(np.abs(got[k][mask] - ref[k][mask]).max())
                  for k in ("boxes", "landmarks"))
    score_err = float(np.abs(got["scores"][mask] - ref["scores"][mask]).max())
    cos = float((got["embeddings"][valid] * ref["embeddings"][valid]
                 ).sum(-1).min())
    if box_err > 1 or score_err > 1e-4 or not cos > 0.999:
        raise AssertionError(f"card vs CPU pipeline: boxes {box_err} counts, "
                             f"scores {score_err}, cosine {cos}")
    peaks = {}
    for d in (dev, "cpu"):
        pipe_d = pipes[d]
        with torch.inference_mode():
            frames_d = pipe_d.put_frames(frames)
            peaks[d] = pipe_d._pose_detect_fn(96, 128)(frames_d)[0].cpu(
                ).numpy()
    matched, unmatched, total = peak_agreement(peaks[dev], peaks["cpu"])
    if unmatched > 0.02 * total:
        raise AssertionError(f"card vs CPU peaks: {unmatched} of {total} "
                             "unmatched")
    same_people = [[p["keypoints"].tolist() for p in f] for f in got["poses"]
                   ] == [[p["keypoints"].tolist() for p in f]
                         for f in ref["poses"]]
    if not same_people:
        raise AssertionError("card vs CPU pipeline: humans differ")
    log(f"card vs CPU float32 pipeline (2 x 96x128, det and pose short side "
        f"96): masks equal ({int(mask.sum())} faces, {int(valid.sum())} "
        f"embedded), boxes/landmarks within {box_err} count, scores within "
        f"{score_err:.2e}, embedding cosine >= {cos:.6f}; peaks: {matched} of "
        f"{total} matched, {unmatched} unmatched; "
        f"{sum(map(len, ref['poses']))} humans, keypoints equal ({card})")


def peak_agreement(got, ref):
    """(matched, unmatched, total) valid peaks between two (N, P, K, 5)
    peak tables: a peak matches one of the same image and part within one
    pixel and 1e-4 of score."""
    matched = unmatched = 0
    for g_part, r_part in zip(got.reshape(-1, *got.shape[-2:]),
                              ref.reshape(-1, *ref.shape[-2:])):
        g = g_part[g_part[:, 3] > 0.5]
        r = r_part[r_part[:, 3] > 0.5]
        hits = 0
        for peak in r:
            close = ((abs(g[:, 0] - peak[0]) <= 1) & (abs(g[:, 1] - peak[1])
                                                      <= 1)
                     & (abs(g[:, 2] - peak[2]) <= 1e-4))
            hits += bool(close.any())
        matched += hits
        unmatched += len(r) - hits + max(0, len(g) - hits)
    total = int((ref[..., 3] > 0.5).sum())
    return matched, unmatched, total


def native_phase():
    """Build the native pose assembly with g++ and require it loaded: the
    pipeline's assembly would otherwise fall back to Python unseen.
    Returns the seconds of the first load, build included."""
    import shutil

    from terran_tpu_torch import native

    if not native.native_available():
        raise AssertionError(f"the native assembly did not load: "
                             f"{native.build_error()}")
    log(f"build: native assembly (terran_tpu_torch/native/assembly.cpp, "
        f"{shutil.which('g++')}) loaded in {native.build_seconds():.2f} s")
    return native.build_seconds()


def sampled_limbs_phase(paf, coords, valid, card):
    """Limb scores sampled from the x1 PAF field against the materialised
    x8 field, on the model's PAFs and peaks: equal (reg bit for bit, the
    same accept flags), and both timed with CUDA events. Returns their
    fields."""
    import torch

    from terran_tpu_torch.config import get_config
    from terran_tpu_torch.ops.pose_decode import (
        limb_scores, limb_scores_sampled,
    )
    from terran_tpu_torch.ops.upsample import upsample_bicubic

    threshold = get_config().paf_midpoint_threshold

    def materialised():
        with torch.inference_mode():
            return limb_scores(upsample_bicubic(paf, 8), coords, valid,
                               threshold)

    def sampled():
        with torch.inference_mode():
            return limb_scores_sampled(paf, 8, coords, valid, threshold)

    (reg_m, acc_m), (reg_s, acc_s) = materialised(), sampled()
    torch.cuda.synchronize()
    if not (torch.equal(reg_m, reg_s) and torch.equal(acc_m, acc_s)):
        raise AssertionError("sampled and materialised limb scores differ")
    ms_m, ms_s = time_ms(materialised), time_ms(sampled)
    k = coords.shape[-2]
    log(f"limb scores at K={k} on the model's PAFs {tuple(paf.shape)} "
        f"({card}): materialised (x8 upsample + gather) {ms_m:.4f} ms, "
        f"sampled {ms_s:.4f} ms; equal ({int(valid.sum())} peaks, "
        f"{int(acc_m.sum())} accepted pairs of {acc_m.numel()})")
    return {"k": k, "materialised_ms": ms_m, "sampled_ms": ms_s,
            "equal": True}


def pipeline_host_phase(params, batches, card, device, host_resize="auto"):
    """The pipeline at bench.py's configuration under the 'host' transfer
    plan, bf16, with ``host_resize`` ('auto', bench.py's, takes OpenCV
    where it imports): warmup, one batch, one ``dispatch_batch`` of a
    prepared batch that must make no synchronizing call, then PIPE_SWEEPS
    timed ``process_stream`` sweeps, both kernels exactly 2 launches a
    batch. ``device`` is the device plan's fields from this run. Returns
    the fields of the ``pipeline_host`` line."""
    import torch

    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops import nms
    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    pipe = PerceptionPipeline(**pipeline_kwargs(
        params, timer=timer, transfer_plan="host", host_resize=host_resize))
    resize = "cv2" if pipe._uses_cv2() else "exact"
    start = time.perf_counter()
    programs = pipe.warmup(BATCH, *FRAME)
    warm_s = time.perf_counter() - start
    check_pipeline_result(pipe.process_batch(batches[0]), BATCH, PIPE_CONFIG)
    prep = pipe._host_prep(batches[0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        dispatched = pipe.dispatch_batch(prep)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check_pipeline_result(pipe.finalize_batch(*dispatched), BATCH,
                          PIPE_CONFIG)
    for _ in pipe.process_stream(batches[:2], depth=PIPE_DEPTH):
        pass

    timer.reset()
    uploaded = pipe.upload_bytes
    fp.find_peaks_fused.launches = 0
    nms.suppress.launches = 0
    fps = []
    for _ in range(PIPE_SWEEPS):
        start = time.perf_counter()
        outs = list(pipe.process_stream(batches, depth=PIPE_DEPTH))
        fps.append(BATCH * PIPE_BATCHES / (time.perf_counter() - start))
        for out in outs:
            check_pipeline_result(out, BATCH, PIPE_CONFIG)
    swept = PIPE_SWEEPS * PIPE_BATCHES
    upload_per_frame = (pipe.upload_bytes - uploaded) / (swept * BATCH)
    launches = {"fused_peaks": fp.find_peaks_fused.launches,
                "nms": 2 * nms.suppress.launches}
    pipe.close()
    for name, count in launches.items():
        if count != 2 * swept:
            raise AssertionError(f"the host plan launched {name}'s kernels "
                                 f"{count} times over {swept} batches")
    fps_median = sorted(fps)[len(fps) // 2]
    summary = timer.summary()
    stages = {name: 1e3 * summary[name]["total_s"] / swept
              for name in ("host_resize_thread", "h2d_thread",
                           "embed_host_warp", "embed_dispatch")}
    picks = "host" if fps_median > device["fps_median"] else "device"
    log(f"pipeline, transfer_plan='host' ({card}): host_resize "
        f"'{host_resize}', so {resize}; "
        f"warmup {programs} programs in {warm_s:.3f} s; frames/s per sweep "
        + ", ".join(f"{f:.2f}" for f in fps)
        + f"; median {fps_median:.2f} frames/s = "
        f"{BATCH * 1e3 / fps_median:.2f} ms/batch, against the device "
        f"plan's {device['fps_median']:.2f} in this run (bench.py's rule "
        f"picks '{picks}'); upload bytes a frame {upload_per_frame:.0f} "
        f"(device plan {device['upload_bytes_per_frame']:.0f}); stage ms "
        "per batch " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; kernel launches per batch: fused_peaks "
        f"{launches['fused_peaks'] / swept:g}, nms {launches['nms'] / swept:g}")
    log(f"pipeline host plan ({resize}) stage timer (host wall time, the "
        "sweeps): " + json.dumps(summary))
    return {"fps": fps, "fps_median": fps_median,
            "batch_ms": BATCH * 1e3 / fps_median, "warmup_programs": programs,
            "warmup_s": warm_s, "batches": swept, "launches": launches,
            "stages_ms_per_batch": stages, "stages": summary,
            "upload_bytes_per_frame": upload_per_frame, "picks": picks,
            "host_resize": resize}


def synthetic_decode_outputs(rng, k, frames):
    """Per frame, pose decode outputs as the device gives them: valid
    peaks a prefix of each part's K slots, limbs accepted only between
    valid slots (30% of those pairs)."""
    import numpy as np

    from terran_tpu_torch.ops.pose_decode import COCO_18

    parts, limbs = COCO_18.parts, COCO_18.limbs
    out = []
    for _ in range(frames):
        coords = rng.integers(0, 1000, (parts, k, 2)).astype(np.int32)
        scores = rng.uniform(0.1, 1.0, (parts, k)).astype(np.float32)
        counts = rng.binomial(k, 0.9, parts)
        valid = np.arange(k)[None, :] < counts[:, None]
        reg = rng.uniform(-0.5, 1.0, (limbs, k, k)).astype(np.float32)
        accept = rng.uniform(size=(limbs, k, k)) < 0.3
        for limb, (src, dst) in enumerate(COCO_18.limbseq):
            accept[limb] &= valid[src][:, None] & valid[dst][None, :]
        out.append((coords, scores, valid, reg, accept))
    return out


def assembly_phase(card):
    """Host assembly of a batch of BATCH frames at the pipeline's K,
    native against Python: host ms a batch (median of 5 alternating runs
    each) and the same humans (peak ids and counts equal, score sums
    within 1e-9). Returns its fields."""
    import numpy as np

    from terran_tpu_torch.pose.assembly import assemble_humans

    k = PIPE_CONFIG["max_peaks"]
    outputs = synthetic_decode_outputs(np.random.default_rng(SEED + 4), k,
                                       BATCH)
    times = {True: [], False: []}
    humans = {}
    for _ in range(5):
        for use_native in (True, False):
            start = time.perf_counter()
            humans[use_native] = [
                assemble_humans(*o, use_native=use_native)[1]
                for o in outputs]
            times[use_native].append(1e3 * (time.perf_counter() - start))
    for got, expected in zip(humans[True], humans[False]):
        if (got.shape != expected.shape
                or not np.array_equal(got[:, :18], expected[:, :18])
                or not np.array_equal(got[:, 19], expected[:, 19])
                or not np.allclose(got[:, 18], expected[:, 18], rtol=0,
                                   atol=1e-9)):
            raise AssertionError("native and Python assembly differ")
    native_ms, python_ms = (sorted(times[u])[2] for u in (True, False))
    accepted = sum(int(o[4].sum()) for o in outputs)
    people = sum(len(h) for h in humans[True])
    log(f"host assembly of {BATCH} frames at K={k} ({card} host): native "
        f"{native_ms:.3f} ms, Python {python_ms:.3f} ms a batch (median of "
        f"5); {accepted} accepted limb pairs, {people} humans, the same")
    return {"k": k, "native_ms": native_ms, "python_ms": python_ms,
            "accepted_pairs": accepted, "humans": people}


def pipeline_host_float32_phase(params, rng, dev, card):
    """float32, TF32 off, deterministic cuDNN, at dyadic scales (2 frames
    of 736x1312, det short side 368 = x1/2, pose 184 = x1/4, where the
    host's exact bilinear equals the card's): the host plan against the device
    plan on the card. Masks, overflow flags, boxes, landmarks, scores and
    keypoints equal; embeddings within atol 2e-4 (the JAX package's own
    tolerance between its plans); the host warp's crops within one count
    of the card's warp (a .5 tie may round the other way)."""
    import numpy as np
    import torch

    from terran_tpu_torch.ops.warp import (
        alignment_matrices, warp_affine_batch, warp_affine_u8_batch_numpy,
    )
    from terran_tpu_torch.pipeline import PerceptionPipeline

    config = dict(compute_dtype=torch.float32, det_short_side=368,
                  pose_short_side=184)
    frames = rng.integers(0, 255, (2, 736, 1312, 3), dtype=np.uint8)
    ref = PerceptionPipeline(**pipeline_kwargs(params, **config)
                             ).process_batch(frames)
    with PerceptionPipeline(**pipeline_kwargs(
            params, transfer_plan="host", host_resize="exact",
            **config)) as host:
        got = host.process_batch(frames)
    for key in ("boxes", "landmarks", "scores", "mask", "det_overflow",
                "pose_overflow", "embeddings_mask"):
        if not np.array_equal(got[key], ref[key]):
            raise AssertionError(f"host vs device plan: {key} differs")
    if ([[p["keypoints"].tolist() for p in f] for f in got["poses"]]
            != [[p["keypoints"].tolist() for p in f] for f in ref["poses"]]):
        raise AssertionError("host vs device plan: keypoints differ")
    valid = ref["embeddings_mask"]
    err = float(np.abs(got["embeddings"] - ref["embeddings"]).max())
    if not err <= 2e-4:
        raise AssertionError(f"host vs device plan: embeddings differ by "
                             f"{err}")
    differing = worst = 0
    for i in range(len(frames)):
        slots = np.flatnonzero(valid[i])
        mats = alignment_matrices(
            ref["landmarks"][i, slots].astype(np.float32))
        on_host = warp_affine_u8_batch_numpy(frames[i], mats)
        with torch.inference_mode():
            on_card = torch.round(warp_affine_batch(
                torch.from_numpy(frames[i]).to(dev), mats)).cpu().numpy()
        diff = np.abs(on_host.astype(np.float32) - on_card)
        differing += int((diff > 0).sum())
        worst = max(worst, float(diff.max(initial=0.0)))
    if worst > 1:
        raise AssertionError(f"host vs card warp: {worst} counts apart")
    log(f"float32 host vs device plan on the card (2 x 736x1312, det x1/2, "
        f"pose x1/4): masks, boxes, scores, keypoints equal "
        f"({int(ref['mask'].sum())} faces, {int(valid.sum())} embedded, "
        f"{sum(map(len, ref['poses']))} humans); embeddings within "
        f"{err:.2e}; host vs card warp: {differing} crop values differ, by "
        f"at most {worst:g} ({card})")
    return {"embedding_err": err, "crop_values_differing": differing}


def slab_replay(model, frame, n, halo, threshold, top_k, local_top_k,
                nms_threshold, device):
    """The spatial path's arithmetic for ``n`` slabs in one process, as
    tests/test_spatial.py's oracle replays it: each extended slab sliced
    by hand from the zero-padded frame (zeros past its edges), the model,
    the anchor decode, ``slab_candidates`` as rank i, then one
    ``nms_fixed`` over the slabs' candidates in slab order. Returns the
    kept (boxes, landmarks, scores) as numpy, the merged overflow flag and
    each slab's pre-selection overflow."""
    import numpy as np
    import torch

    from terran_tpu_torch.models.retinaface import decode_outputs
    from terran_tpu_torch.ops.nms import nms_fixed
    from terran_tpu_torch.parallel.spatial import (
        GRID, ext_anchor_meta, slab_candidates, slab_layout,
    )

    h, w = frame.shape[:2]
    slab_h, padded_h = slab_layout(h, n)
    padded_w = -(-w // GRID) * GRID
    halo = min(halo, slab_h)
    padded = np.zeros((padded_h, padded_w, 3), np.uint8)
    padded[:h, :w] = frame
    anchors = torch.from_numpy(
        ext_anchor_meta(slab_h, padded_w, halo)[0]).to(device)
    cands = []
    with torch.inference_mode():
        for i in range(n):
            start = i * slab_h
            ext = np.zeros((slab_h + 2 * halo, padded_w, 3), np.uint8)
            lo, hi = max(0, start - halo), min(padded_h,
                                               start + slab_h + halo)
            ext[lo - (start - halo):hi - (start - halo)] = padded[lo:hi]
            x = torch.from_numpy(ext)[None].to(device)
            scores, boxes, landmarks = decode_outputs(
                model(x.to(model.compute_dtype)), anchors)
            cands.append(slab_candidates(
                scores[0], boxes[0], landmarks[0], device_index=i,
                slab_h=slab_h, halo=halo, width=padded_w, valid_h=h,
                valid_w=w, threshold=threshold, local_top_k=local_top_k))
        kb, ks, keep, order, merged = nms_fixed(
            torch.cat([c[0] for c in cands]),
            torch.cat([c[2] for c in cands]), nms_threshold,
            score_threshold=threshold, top_k=top_k)
        kl = torch.cat([c[1] for c in cands])[order]
        keep = keep.cpu().numpy()
        return ((kb.cpu().numpy()[keep], kl.cpu().numpy()[keep],
                 ks.cpu().numpy()[keep]), bool(merged),
                [bool(c[3]) for c in cands])


def faces_arrays(faces):
    """(boxes, landmarks, scores) arrays of a task-API face list."""
    import numpy as np

    return (np.array([f["bbox"] for f in faces], np.float32).reshape(-1, 4),
            np.array([f["landmarks"] for f in faces],
                     np.float32).reshape(-1, 5, 2),
            np.array([f["score"] for f in faces], np.float32))


def kept_error(got, expected, label, coords_rtol=0.0):
    """Max abs error of two kept (boxes, landmarks, scores) triples; the
    counts must agree, scores within 1e-5 and coordinates within 1e-2
    plus ``coords_rtol`` of their size (tests/test_spatial.py's)."""
    import numpy as np

    if len(got[2]) != len(expected[2]) or not len(got[2]):
        raise AssertionError(f"{label}: {len(got[2])} faces kept against "
                             f"{len(expected[2])}")
    worst = 0.0
    for name, g, e in zip(("boxes", "landmarks", "scores"), got, expected):
        err = np.abs(g.astype(np.float64) - e)
        tol = (1e-5 if name == "scores"
               else 1e-2 + coords_rtol * np.abs(e.astype(np.float64)))
        if not (err <= tol).all():
            raise AssertionError(f"{label}: {name} differ by up to "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def assert_same_pipeline(got, expected, what):
    """Two ``process_batch`` results equal, every output and pose."""
    import numpy as np

    for key in ("boxes", "landmarks", "scores", "mask", "det_overflow",
                "embeddings", "embeddings_mask", "pose_overflow"):
        if not np.array_equal(got[key], expected[key]):
            raise AssertionError(f"{what}: {key} differs")
    if ([[(p["keypoints"].tolist(), p["score"]) for p in f]
         for f in got["poses"]]
            != [[(p["keypoints"].tolist(), p["score"]) for p in f]
                for f in expected["poses"]]):
        raise AssertionError(f"{what}: poses differ")


def scaleout_phase(params, rf_params, batches, model_boxes, dev, card):
    """Scale-out over torch.distributed on one card: ``create_mesh()``
    brings up a world-1 NCCL group over a loopback store (the backend must
    be nccl and the device cuda:0), and the group is destroyed at the end,
    failure or not. In it:

    - the pipeline at bench.py's configuration under the mesh against the
      same pipeline without one: warmup each, one batch each with
      deterministic cuDNN, every output equal; then PIPE_SWEEPS timed
      ``process_stream`` sweeps of each, interleaved, the kernels' counts
      set to 0 just before each mesh sweep and read just after (both
      kernels on every batch);
    - the int8 trunks under the 'host' plan with and without the mesh:
      one batch each with deterministic cuDNN, every output equal, each
      timed;
    - ``make_sharded_nms`` at world 1 (local_top_k = every anchor) against
      ``nms_fixed`` on the detector's decoded boxes of one 1080p frame:
      boxes, scores, keep and overflow equal, ``order`` through the
      pre-selection's permutation equal; both timed with CUDA events;
    - ``SpatialShardedDetector`` at world 1 (halo 256, top_k 256, no
      escalation, bf16) on one seeded 2160x3840 frame against
      RetinaFaceDetector's model on the same frame between zero halos,
      replayed by hand (tests/test_spatial.py:195's comparison), at
      test_spatial.py's tolerances; timed;
    - a 4-slab layout of that frame (slab 544, halo 256) replayed slab by
      slab on the card and merged by ``nms_fixed`` there, in float32 with
      TF32 off, against the same replay on the CPU: the same faces kept,
      scores within 1e-5, coordinates within 1e-2 + 1e-4 of their size
      (the float32 heads differ by summation order).

    Returns the fields of the ``scaleout`` line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from terran_tpu_torch.face.detection import RetinaFaceDetector
    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops import nms
    from terran_tpu_torch.parallel import (
        SpatialShardedDetector, create_mesh, slab_layout,
    )
    from terran_tpu_torch.pipeline import PerceptionPipeline

    if dist.is_initialized():
        raise AssertionError("a process group exists before the scale-out "
                             "phase")
    mesh = create_mesh()
    try:
        if (mesh.backend, mesh.device, mesh.size) != (
                "nccl", torch.device("cuda", 0), 1):
            raise AssertionError(f"mesh: backend {mesh.backend}, device "
                                 f"{mesh.device}, size {mesh.size}")
        plain = PerceptionPipeline(**pipeline_kwargs(params))
        meshed = PerceptionPipeline(**pipeline_kwargs(params, mesh=mesh))
        for pipe in (plain, meshed):
            pipe.warmup(BATCH, *FRAME)

        assert_same = assert_same_pipeline
        torch.backends.cudnn.deterministic = True
        # The mesh pipeline runs its programs' eager launches: so does the
        # plain one here, its captured graphs set aside.
        graphs, plain._graphs = plain._graphs, {}
        try:
            expected = plain.process_batch(batches[0])
            got = meshed.process_batch(batches[0])
        finally:
            torch.backends.cudnn.deterministic = False
            plain._graphs = graphs
        assert_same(got, expected, "mesh vs no-mesh pipeline")
        for pipe in (plain, meshed):  # ramp, as pipeline_phase does
            for _ in pipe.process_stream(batches[:2], depth=PIPE_DEPTH):
                pass

        fps = {"mesh": [], "plain": []}
        launches = {"fused_peaks": 0, "nms": 0}
        for _ in range(PIPE_SWEEPS):
            for name, pipe in (("plain", plain), ("mesh", meshed)):
                if name == "mesh":
                    fp.find_peaks_fused.launches = 0
                    nms.suppress.launches = 0
                start = time.perf_counter()
                outs = list(pipe.process_stream(batches, depth=PIPE_DEPTH))
                fps[name].append(BATCH * PIPE_BATCHES
                                 / (time.perf_counter() - start))
                if name == "mesh":
                    launches["fused_peaks"] += fp.find_peaks_fused.launches
                    launches["nms"] += 2 * nms.suppress.launches
                for out in outs:
                    check_pipeline_result(out, BATCH, PIPE_CONFIG)
        swept = PIPE_SWEEPS * PIPE_BATCHES
        for name, count in launches.items():
            if count < 2 * swept:
                raise AssertionError(f"the mesh pipeline launched {name}'s "
                                     f"kernels {count} times over {swept} "
                                     "batches")
        median = {name: sorted(v)[len(v) // 2] for name, v in fps.items()}
        log(f"scale-out ({card}): world-1 {mesh.backend} mesh on "
            f"{mesh.device}; pipeline at {PIPE_CONFIG}, {PIPE_SWEEPS} "
            f"interleaved sweeps of {PIPE_BATCHES} batches x {BATCH} x "
            f"{FRAME[0]}x{FRAME[1]}: mesh frames/s "
            + ", ".join(f"{f:.2f}" for f in fps["mesh"])
            + f" (median {median['mesh']:.2f}) against no mesh "
            + ", ".join(f"{f:.2f}" for f in fps["plain"])
            + f" (median {median['plain']:.2f}); one batch equal bit for "
            f"bit; kernel launches per batch under the mesh: fused_peaks "
            f"{launches['fused_peaks'] / swept:g}, nms "
            f"{launches['nms'] / swept:g}")
        del plain, meshed

        # The int8 trunks (one all-reduce of each conv's activation scale
        # under the mesh) and the 'host' plan (the embed program on the
        # main thread under the mesh), one batch each way, timed.
        int8_host = {"transfer_plan": "host", "embed_precision": "int8",
                     "pose_precision": "int8"}
        int8_runs = {}
        torch.backends.cudnn.deterministic = True
        try:
            for name, extra in (("plain", {}), ("mesh", {"mesh": mesh})):
                with PerceptionPipeline(**pipeline_kwargs(
                        params, **int8_host, **extra)) as pipe:
                    int8_runs[name] = timed_calls(
                        lambda pipe=pipe: pipe.process_batch(batches[0]))
        finally:
            torch.backends.cudnn.deterministic = False
        assert_same(int8_runs["mesh"][0], int8_runs["plain"][0],
                    "int8 'host'-plan pipeline, mesh vs no mesh")
        int8_ms = {name: run[2] for name, run in int8_runs.items()}
        log(f"scale-out ({card}): int8 trunks under the 'host' plan, one "
            f"batch of {BATCH} equal bit for bit with and without the "
            f"world-1 mesh; {int8_ms['mesh']:.2f} against "
            f"{int8_ms['plain']:.2f} ms a batch (median of {TIMED_CALLS} "
            f"process_batch calls, host clock)")
        del int8_runs

        # The sharded NMS at world 1 against nms_fixed.
        boxes, scores = model_boxes[0][0], model_boxes[1][0]
        anchors = scores.shape[0]
        run = nms.make_sharded_nms(mesh, iou_threshold=0.4,
                                   score_threshold=0.5, local_top_k=anchors,
                                   top_k=256)
        nms.suppress.launches = 0
        sharded = run(boxes, scores)
        nms_calls = nms.suppress.launches
        direct = nms.nms_fixed(boxes, scores, 0.4, score_threshold=0.5,
                               top_k=256)
        perm = torch.sort(torch.where(scores >= 0.5, scores, float("-inf")),
                          descending=True, stable=True)[1]
        for name, g, e in (("boxes", sharded[0], direct[0]),
                           ("scores", sharded[1], direct[1]),
                           ("keep", sharded[2], direct[2]),
                           ("overflow", sharded[4], direct[4]),
                           ("order", perm[sharded[3]], direct[3])):
            if not torch.equal(g, e):
                raise AssertionError(f"make_sharded_nms at world 1 vs "
                                     f"nms_fixed: {name} differs")
        sharded_ms = time_ms(lambda: run(boxes, scores))
        direct_ms = time_ms(lambda: nms.nms_fixed(
            boxes, scores, 0.4, score_threshold=0.5, top_k=256))
        log(f"make_sharded_nms at world 1 == nms_fixed on {anchors} decoded "
            f"anchors (top_k 256, {int(direct[2].sum())} kept, overflow "
            f"{bool(direct[4])}): {sharded_ms:.4f} ms against "
            f"{direct_ms:.4f} ms a call ({card})")

        # SpatialShardedDetector at world 1 on a 4K frame.
        frame = np.random.default_rng(SEED + 6).integers(
            0, 255, TILED_FRAME + (3,), dtype=np.uint8)
        detector = RetinaFaceDetector(params=rf_params)
        spatial = SpatialShardedDetector(detector, mesh=mesh, halo=256,
                                         top_k=256, max_escalations=0)
        nms.suppress.launches = 0
        faces, warm_s, spatial_ms = timed_calls(lambda: spatial(frame, 0.5))
        spatial_nms_calls = nms.suppress.launches
        if spatial_nms_calls != 1 + TIMED_CALLS:
            raise AssertionError(f"{spatial_nms_calls} NMS calls over "
                                 f"{1 + TIMED_CALLS} spatial calls")
        replayed, _, _ = slab_replay(
            detector.model, frame, 1, spatial.halo, 0.5, 256, 256,
            detector.nms_threshold, dev)
        spatial_err = kept_error(faces_arrays(faces), replayed,
                                 "spatial world 1 vs the detector's model")
        log(f"SpatialShardedDetector at world 1 ({TILED_FRAME[0]}x"
            f"{TILED_FRAME[1]}, halo 256, top_k 256, bf16): {len(faces)} "
            f"faces, equal to the detector's model on the frame between "
            f"zero halos (max abs error {spatial_err:.2e}); warm call "
            f"{warm_s:.3f} s, {spatial_ms:.2f} ms a call (median of "
            f"{TIMED_CALLS}, host clock); {spatial_nms_calls} NMS calls "
            f"over {1 + TIMED_CALLS} calls ({card})")

        # The 4-slab layout, replayed on the card and on the CPU.
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            replays, replay_ms = {}, []
            for device in (dev, dev, "cpu"):  # the card's second call warm
                det32 = RetinaFaceDetector(params=rf_params, device=device,
                                           compute_dtype=torch.float32)
                nms.suppress.launches = 0
                start = time.perf_counter()
                replays[device] = slab_replay(
                    det32.model, frame, SCALEOUT_SLABS, 256, 0.5, 256, 256,
                    det32.nms_threshold, device)
                if device == dev:
                    torch.cuda.synchronize()
                    replay_ms.append(1e3 * (time.perf_counter() - start))
                    replay_nms_calls = nms.suppress.launches
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
        (card_kept, card_merged, card_slabs) = replays[dev]
        (cpu_kept, cpu_merged, cpu_slabs) = replays["cpu"]
        if (card_merged, card_slabs) != (cpu_merged, cpu_slabs):
            raise AssertionError("4-slab replay: overflow flags differ "
                                 "between the card and the CPU")
        replay_err = kept_error(card_kept, cpu_kept,
                                "4-slab replay, card vs CPU", 1e-4)
        if replay_nms_calls != 1:
            raise AssertionError(f"4-slab replay: {replay_nms_calls} NMS "
                                 "kernel calls on the card, expected 1")
        log(f"4-slab replay of the {TILED_FRAME[0]}x{TILED_FRAME[1]} frame "
            f"(slab {slab_layout(TILED_FRAME[0], SCALEOUT_SLABS)[0]}, halo "
            f"256, float32, TF32 off): card == CPU, "
            f"{len(card_kept[2])} faces kept, max abs error "
            f"{replay_err:.2e}; per-slab overflow {card_slabs}, merged "
            f"{card_merged}; {replay_ms[1]:.2f} ms on the card warm "
            f"({replay_ms[0]:.2f} ms the first call, host clock), its merge "
            f"NMS on the card ({card})")
        return {"backend": mesh.backend, "device": str(mesh.device),
                "world_size": mesh.size,
                "pipeline_frames_per_s": median["mesh"],
                "pipeline_frames_per_s_sweeps": fps["mesh"],
                "no_mesh_frames_per_s": median["plain"],
                "no_mesh_frames_per_s_sweeps": fps["plain"],
                "ratio_to_no_mesh": median["mesh"] / median["plain"],
                "launches": launches, "batches": swept,
                "launches_per_batch": {k: v / swept
                                       for k, v in launches.items()},
                "int8_host_plan_ms_per_batch": int8_ms["mesh"],
                "int8_host_plan_no_mesh_ms_per_batch": int8_ms["plain"],
                "sharded_nms_ms": sharded_ms, "nms_fixed_ms": direct_ms,
                "sharded_nms_calls": nms_calls,
                "spatial_ms": spatial_ms, "spatial_faces": len(faces),
                "spatial_nms_calls": spatial_nms_calls,
                "spatial_calls": 1 + TIMED_CALLS,
                "spatial_max_abs_err": spatial_err,
                "replay_4_slab_ms": replay_ms[1],
                "replay_4_slab_first_ms": replay_ms[0],
                "replay_4_slab_faces": len(card_kept[2]),
                "replay_4_slab_max_abs_err": replay_err,
                "replay_4_slab_nms_calls": replay_nms_calls}
    finally:
        dist.destroy_process_group()


def environment_phase():
    """The host libraries the slice's paths need on the card's machine:
    scipy (the tracker's assignment; an ImportError fails the run), an
    ffmpeg binary (the video reader and writer; only recorded, the smoke
    feeds synthetic streams), and whether the leaf group's libraries
    import (Pillow, pycairo, click, requests, matplotlib) and where feh is
    (only recorded)."""
    import shutil

    import scipy
    from scipy.optimize import linear_sum_assignment  # noqa: F401

    env = {"scipy": scipy.__version__, "ffmpeg": shutil.which("ffmpeg"),
           "ffprobe": shutil.which("ffprobe"), "feh": shutil.which("feh")}
    # The leaf group's libraries: recorded only.
    for name in LEAF_LIBRARIES:
        env[name] = importable(name)
    log(f"environment: scipy {env['scipy']}, ffmpeg {env['ffmpeg']}, "
        f"ffprobe {env['ffprobe']}, feh {env['feh']}; "
        + ", ".join(f"{name} {env[name]}" for name in LEAF_LIBRARIES))
    return env


def importable(name):
    """The version of module ``name`` where it imports, "no" where it does
    not."""
    import importlib

    try:
        module = importlib.import_module(name)
    except ImportError:
        return "no"
    return str(getattr(module, "__version__", "yes"))


def stream_sources():
    """STREAMS seeded 1080p noise streams of STREAM_FRAMES frames, read
    STREAM_SOURCE_BATCH frames at a time (examples/streams.py's source
    batch)."""
    from terran_tpu_torch.io.video import SyntheticVideo

    return [SyntheticVideo(width=FRAME[1], height=FRAME[0],
                           num_frames=STREAM_FRAMES,
                           batch_size=STREAM_SOURCE_BATCH, seed=i,
                           pattern="noise")
            for i in range(STREAMS)]


def tracked(faces, base):
    """(relative track id, bbox, landmarks, score) of tracked faces."""
    return [(face["track"] - base, face["bbox"].tolist(),
             face["landmarks"].tolist(), float(face["score"]))
            for face in faces]


def streams_phase(pipe, card):
    """The slice's main path: STREAMS concurrent 1080p streams through
    ``MultiStreamPerception`` on the warm pipeline, batch BATCH, with
    per-stream SORT tracking, STREAM_SWEEPS timed sweeps. Every (stream,
    frame) once, frame indices contiguous from 0, every batch's
    perception and pose programs called before it is yielded and every
    program call a replay (the kernels those replay are counted in phase
    6, under the profiler), the host time in
    ``Sort.update``; plain ``process_stream`` over the same multiplexed
    batches timed beside it. Then the faces, embeddings, poses and tracks
    against ``process_batch`` on those batches and a fresh ``Sort`` per
    stream (ids relative to the tracker counter at the start). Returns
    the fields of the ``streams`` line."""
    import numpy as np

    from terran_tpu_torch.io.streams import (
        MultiStreamPerception, StreamMultiplexer,
    )
    from terran_tpu_torch.tracking.face import KalmanTracker

    frames_total = STREAMS * STREAM_FRAMES
    batches = frames_total // BATCH
    sweeps = []
    for _ in range(STREAM_SWEEPS):
        msp = MultiStreamPerception(pipe, stream_sources(), batch_size=BATCH,
                                    track=True)
        track_s = []
        for tracker in msp.trackers:
            def update(faces, _update=tracker.update):
                start = time.perf_counter()
                out = _update(faces)
                track_s.append(time.perf_counter() - start)
                return out
            tracker.update = update
        base = KalmanTracker.count
        calls, since = dict(pipe.graph_calls), dispatched(pipe)
        results = []
        start = time.perf_counter()
        for i, batch in enumerate(msp):
            # Batch i was dispatched before it is yielded: its perception
            # and pose programs, which hold both kernels, were called.
            if min(dispatched(pipe, since)) < i + 1:
                raise AssertionError(f"streams batch {i}: perception and "
                                     f"pose dispatches "
                                     f"{dispatched(pipe, since)}")
            results.extend(batch)
        elapsed = time.perf_counter() - start
        check_replayed(pipe, calls, batches, since, "streams")
        if len(track_s) != frames_total:
            raise AssertionError(f"{len(track_s)} Sort.update calls for "
                                 f"{frames_total} frames")
        sweeps.append({"fps": frames_total / elapsed, "results": results,
                       "base": base,
                       "track_ms_per_batch": 1e3 * sum(track_s) / batches})

    seen = [(r["stream"], r["frame"]) for r in sweeps[-1]["results"]]
    if len(seen) != len(set(seen)) or len(seen) != frames_total:
        raise AssertionError(f"streams: {len(seen)} results, "
                             f"{len(set(seen))} distinct (stream, frame)")
    for stream in range(STREAMS):
        if sorted(f for s, f in seen if s == stream) != list(
                range(STREAM_FRAMES)):
            raise AssertionError(f"stream {stream}: frame indices are not "
                                 "contiguous from 0")

    # Plain process_stream over the same multiplexed batches (no tracking,
    # no synthetic decode or stacking on the upload thread).
    muxed = list(StreamMultiplexer(stream_sources(), batch_size=BATCH))
    if [len(meta) for _, meta in muxed] != [BATCH] * batches:
        raise AssertionError("the multiplexer did not fill every batch")
    plain_fps = []
    for _ in range(STREAM_SWEEPS):
        start = time.perf_counter()
        outs = list(pipe.process_stream([f for f, _ in muxed],
                                        depth=PIPE_DEPTH))
        plain_fps.append(frames_total / (time.perf_counter() - start))
    del outs

    # The same frames through process_batch and a fresh Sort per stream,
    # built as MultiStreamPerception builds them.
    trackers = MultiStreamPerception(pipe, stream_sources(),
                                     batch_size=BATCH).trackers
    base = KalmanTracker.count
    expected = []
    detections = 0
    for frames, meta in muxed:
        out = pipe.process_batch(frames)
        faces_per_frame = pipe.faces_from(out)
        detections += sum(map(len, faces_per_frame))
        for slot, (stream, frame) in enumerate(meta):
            faces = trackers[stream].update(faces_per_frame[slot])
            expected.append({
                "stream": stream, "frame": frame, "faces": faces,
                "embeddings": out["embeddings"][slot][
                    out["embeddings_mask"][slot]],
                "pose": out["poses"][slot]})
    got = sweeps[-1]["results"]
    emb_err = 0.0
    for g, e in zip(got, expected):
        if (g["stream"], g["frame"]) != (e["stream"], e["frame"]):
            raise AssertionError("streams: results out of order")
        if tracked(g["faces"], sweeps[-1]["base"]) != tracked(e["faces"],
                                                              base):
            raise AssertionError(f"streams: faces or tracks of stream "
                                 f"{g['stream']} frame {g['frame']} differ "
                                 "from process_batch + a fresh Sort")
        if g["embeddings"].shape != e["embeddings"].shape:
            raise AssertionError("streams: embeddings differ in shape")
        if g["embeddings"].size:
            emb_err = max(emb_err, float(np.abs(g["embeddings"]
                                                - e["embeddings"]).max()))
        if ([p["keypoints"].tolist() for p in g["pose"]]
                != [p["keypoints"].tolist() for p in e["pose"]]):
            raise AssertionError("streams: poses differ from process_batch")
    if emb_err > 1e-6:
        raise AssertionError(f"streams: embeddings differ from process_batch "
                             f"by {emb_err}")

    confirmed = {stream: len({f["track"] for r in got if r["stream"] == stream
                              for f in r["faces"]})
                 for stream in range(STREAMS)}
    faces_per_frame = sum(len(r["faces"]) for r in got) / frames_total
    detected = detections / frames_total
    fps = [s["fps"] for s in sweeps]
    fps_median = sorted(fps)[len(fps) // 2]
    plain_median = sorted(plain_fps)[len(plain_fps) // 2]
    track_ms = [s["track_ms_per_batch"] for s in sweeps]
    log(f"streams ({card}): {STREAMS} x {STREAM_FRAMES} {FRAME[0]}x{FRAME[1]} "
        f"noise streams (source batch {STREAM_SOURCE_BATCH}) through "
        f"MultiStreamPerception, batch {BATCH}, track=True, {batches} "
        f"batches a sweep: frames/s per sweep "
        + ", ".join(f"{f:.2f}" for f in fps)
        + f", median {fps_median:.2f}; plain process_stream over the same "
        f"batches " + ", ".join(f"{f:.2f}" for f in plain_fps)
        + f", median {plain_median:.2f} ({fps_median / plain_median:.3f}x); "
        f"Sort.update host ms a batch ({BATCH} calls over {STREAMS} trackers) "
        + ", ".join(f"{t:.3f}" for t in track_ms)
        + f"; every (stream, frame) once; confirmed tracks "
        f"per stream {confirmed}; tracked faces a frame {faces_per_frame:.2f} "
        f"of {detected:.2f} detected; faces, tracks and "
        f"poses equal to process_batch + a fresh Sort, embeddings within "
        f"{emb_err:.2e}")
    return {"fps": fps, "fps_median": fps_median, "plain_fps": plain_fps,
            "plain_fps_median": plain_median,
            "ratio": fps_median / plain_median,
            "track_ms_per_batch": track_ms, "batches": batches,
            "confirmed_tracks": confirmed,
            "tracked_faces_per_frame": faces_per_frame,
            "detected_faces_per_frame": detected,
            "embedding_err_vs_batch": emb_err}


def tiled_phase(rf_params, dev, card):
    """``TiledDetector`` (RetinaFace, bf16, tile 1024, overlap 256) on one
    seeded 2160x3840 frame, 15 tiles: the card's tile slicing equal to
    the host's bit for bit; each call's NMS calls equal to the tile
    detect's (one per escalation step) plus one for the merge, whose
    inputs are CUDA tensors; no peak-scan launch (no pose on this path);
    every kept face a tile's detection moved by that tile's origin, with
    its centre inside the frame; median of TIMED_CALLS host-clock calls
    after one warm call. Returns the fields of the ``tiled`` line."""
    import numpy as np
    import torch

    from terran_tpu_torch.face.detection import RetinaFaceDetector
    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops import nms, tiling

    detector = RetinaFaceDetector(params=rf_params)
    if detector.model.compute_dtype != torch.bfloat16:
        raise AssertionError("the tiled path must run bf16")
    tiled = tiling.TiledDetector(detector, tile=TILE, overlap=TILE_OVERLAP)
    frame = np.random.default_rng(SEED + 5).integers(
        0, 255, TILED_FRAME + (3,), dtype=np.uint8)
    origins = tiling.tile_layout(*TILED_FRAME, TILE, TILE_OVERLAP)
    if len(origins) != 15:
        raise AssertionError(f"{len(origins)} tiles, expected 15")
    on_card = tiling.extract_tiles_device(torch.from_numpy(frame).to(dev),
                                          origins, TILE)
    if not torch.equal(on_card.cpu(), torch.from_numpy(
            tiling.extract_tiles(frame, origins, TILE))):
        raise AssertionError("extract_tiles_device differs from "
                             "extract_tiles")

    merges = []
    merge = tiling.nms_fixed

    def spy(boxes, scores, *args, **kwargs):
        merges.append((boxes, scores))
        return merge(boxes, scores, *args, **kwargs)

    tiling.nms_fixed = spy
    calls, peak_launches, times = [], [], []
    try:
        for attempt in range(1 + TIMED_CALLS):
            escalations = detector.escalation_count
            nms.suppress.launches = 0
            fp.find_peaks_fused.launches = 0
            start = time.perf_counter()
            faces = tiled(frame)
            torch.cuda.synchronize()
            if attempt:
                times.append(time.perf_counter() - start)
            tile_calls = 1 + detector.escalation_count - escalations
            calls.append(nms.suppress.launches)
            peak_launches.append(fp.find_peaks_fused.launches)
            if nms.suppress.launches != tile_calls + 1:
                raise AssertionError(
                    f"tiled call: {nms.suppress.launches} NMS calls, "
                    f"expected {tile_calls} for the tiles + 1 for the merge")
            if fp.find_peaks_fused.launches != 0:
                raise AssertionError(
                    f"tiled call: {fp.find_peaks_fused.launches} peak-scan "
                    f"launches on a path without pose")
    finally:
        tiling.nms_fixed = merge
    boxes, scores = merges[-1]
    if not (boxes.is_cuda and scores.is_cuda):
        raise AssertionError(f"the merge ran on {boxes.device}, "
                             f"{scores.device}")
    bucket = boxes.shape[0]
    candidates = int((scores >= 0).sum())

    # Each kept face is one of its tile's detections moved by the origin.
    per_tile = detector.call(on_card)
    shifted = np.concatenate([
        np.concatenate([np.asarray(f["bbox"], np.float32) + (x, y, x, y),
                        (np.asarray(f["landmarks"], np.float32)
                         + (x, y)).ravel()])[None]
        for (y, x), tile_faces in zip(origins, per_tile) for f in tile_faces])
    for face in faces:
        row = np.concatenate([face["bbox"], face["landmarks"].ravel()])
        if not (np.abs(shifted - row).max(axis=1) <= 1e-3).any():
            raise AssertionError("a kept face is no tile's detection moved "
                                 "by its origin")
    kept = np.stack([face["bbox"] for face in faces])
    h, w = TILED_FRAME
    inside = int(((kept[:, 0] >= 0) & (kept[:, 1] >= 0) & (kept[:, 2] <= w)
                  & (kept[:, 3] <= h)).sum())
    centres = int((((kept[:, 0] + kept[:, 2]) / 2 >= 0)
                   & ((kept[:, 0] + kept[:, 2]) / 2 <= w)
                   & ((kept[:, 1] + kept[:, 3]) / 2 >= 0)
                   & ((kept[:, 1] + kept[:, 3]) / 2 <= h)).sum())
    if centres != len(faces):
        raise AssertionError(f"{len(faces) - centres} kept boxes have their "
                             f"centre outside the frame")
    ms = 1e3 * sorted(times)[len(times) // 2]
    log(f"tiled detection ({card}): {TILED_FRAME[0]}x{TILED_FRAME[1]}, tile "
        f"{TILE}, overlap {TILE_OVERLAP}, {len(origins)} tiles, bf16: "
        f"{ms:.2f} ms a call (median of {TIMED_CALLS}, host clock); "
        f"extract_tiles_device == extract_tiles; NMS calls a call {calls} "
        f"(the tile detect's escalation steps + 1 merge on {boxes.device}); "
        f"merge: {candidates} candidates in a bucket of {bucket}, top_k "
        f"{tiled.top_k}, {len(faces)} kept, each a tile's detection at its "
        f"origin; {inside} kept boxes lie inside the frame, {centres} "
        f"centres (random weights give boxes "
        f"{float(np.median(kept[:, 2] - kept[:, 0])):.1f} px wide and "
        f"{float(np.median(kept[:, 3] - kept[:, 1])):.1f} px tall, median)")
    return {"ms": ms, "tiles": len(origins), "nms_calls": calls,
            "peak_launches": peak_launches, "candidates": candidates, "bucket": bucket, "kept": len(faces),
            "inside_frame": inside, "centres_inside_frame": centres,
            "escalations": detector.escalation_count}


def recognition_no_landmarks_phase(arc_params, dev, card):
    """``Recognition`` on NO_LANDMARK_SHAPES seeded whole-face crops with
    no landmarks, bf16: the card's resize + pad within one count of the
    same function on the CPU (values differing counted), embeddings
    finite, unit and (8, 512). Returns its fields."""
    import numpy as np
    import torch

    from terran_tpu_torch.face import Recognition
    from terran_tpu_torch.face.recognition import (
        preprocess_face_no_landmarks,
    )

    rng = np.random.default_rng(SEED + 6)
    crops = [rng.integers(0, 256, shape + (3,), dtype=np.uint8)
             for shape in NO_LANDMARK_SHAPES]
    worst = differing = 0
    for crop in crops:
        on_card = preprocess_face_no_landmarks(
            torch.from_numpy(crop).to(dev))
        if not on_card.is_cuda:
            raise AssertionError("the no-landmarks resize left the card")
        diff = (on_card.cpu().int()
                - preprocess_face_no_landmarks(crop).int()).abs()
        worst = max(worst, int(diff.max()))
        differing += int((diff > 0).sum())
    if worst > 1:
        raise AssertionError(f"no-landmarks crops: card vs CPU {worst} "
                             "counts apart")
    recognition = Recognition(params=arc_params)
    if recognition.model.model.compute_dtype != torch.bfloat16:
        raise AssertionError("the recognition path must run bf16")
    feats, warm_s, ms = timed_calls(lambda: recognition(crops))
    if feats.shape != (len(crops), 512) or feats.dtype != np.float32:
        raise AssertionError(f"no-landmarks embeddings {feats.shape} "
                             f"{feats.dtype}")
    norms = np.linalg.norm(feats, axis=1)
    if not (np.isfinite(feats).all() and np.allclose(norms, 1.0,
                                                     rtol=1e-5)):
        raise AssertionError(f"no-landmarks embeddings not unit: {norms}")
    log(f"recognition without landmarks ({card}): {len(crops)} crops "
        f"{NO_LANDMARK_SHAPES}, bf16: {ms:.2f} ms a call (median of "
        f"{TIMED_CALLS}, warm call {warm_s:.3f} s); card vs CPU resize + "
        f"pad: {differing} values differ, by at most {worst}; embeddings "
        f"{feats.shape}, finite, unit")
    return {"ms": ms, "crops": len(crops), "values_differing": differing,
            "max_count_diff": worst}


# ---------------------------------------------------------------------------
# The opt-in int8 trunks: torch._int_mm (cuBLASLt's IMMA product, a library
# call) behind each quantised conv, no kernel of the repository.
# ---------------------------------------------------------------------------

def int8_models(arc_params, pose_params, dtype, dev):
    """Int8FaceResNet100 and Int8BodyPoseModel in ``dtype`` on ``dev``,
    quantised from the float32 weights."""
    from terran_tpu_torch.models import arcface, openpose

    rec = arcface.Int8FaceResNet100(dtype)
    rec.load_state_dict(arcface.quantize_params(arc_params, dtype))
    pose = openpose.Int8BodyPoseModel(dtype)
    pose.load_state_dict(openpose.quantize_params(pose_params, dtype))
    return rec.to(dev).eval(), pose.to(dev).eval()


def quant_conv_calls(model, x):
    """[(module, input shape)] of every quantised conv in one forward of
    ``model`` on ``x``, in order."""
    import torch

    from terran_tpu_torch.models import quant

    calls, hooks = [], []
    for module in model.modules():
        if isinstance(module, quant.QuantConv2d):
            hooks.append(module.register_forward_pre_hook(
                lambda m, args: calls.append((m, tuple(args[0].shape)))))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for hook in hooks:
            hook.remove()
    return calls


def int8_pipeline_inputs(dev, dtype):
    """The inputs the int8 trunks take in the pipeline at bench.py's
    configuration: BATCH x max_faces = 64 crops for the embed program,
    BATCH 1080p frames resized to the pose short side 184."""
    import torch

    from terran_tpu_torch.ops.pose_decode import normalize_images
    from terran_tpu_torch.ops.resize import resized_shape

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    crops = torch.randint(0, 256, (BATCH * PIPE_CONFIG["max_faces"],
                                   CROP, CROP, 3), generator=gen,
                          device=dev).to(torch.float32)
    pose_h, pose_w, _ = resized_shape(*FRAME, POSE_SIDE)
    frames = torch.randint(0, 256, (BATCH, pose_h, pose_w, 3), generator=gen,
                           dtype=torch.uint8, device=dev)
    return crops, normalize_images(frames).to(dtype)


def int8_conv_bound_ms(m, k, n, in_bytes, out_bytes, weight_bytes):
    """Least time of one quantised conv: 2 m k n int8 operations at the
    tensor cores' int8 rate, or the input read once, the int8 weight read
    once and the output written once over HBM; the larger, and which."""
    t_ops = 2 * m * k * n / PEAK_INT8_OPS
    t_bytes = (in_bytes + out_bytes + weight_bytes) / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def same_values(got, expected):
    """Equal dtype, shape and values, a NaN equal to a NaN."""
    import torch

    if (got.dtype, got.shape) != (expected.dtype, expected.shape):
        return False
    if not got.is_floating_point():
        return torch.equal(got, expected)
    return (torch.equal(got.isnan(), expected.isnan())
            and torch.equal(got.nan_to_num(), expected.nan_to_num()))


def int8_epilogues(module, parents, gen, dtype):
    """{mode name: quant_conv keywords} of the four epilogue modes, with
    the float64 bias and scale of ``module``'s own epilogue where it has
    them (OpenPose's bias, ArcFace's affine on ``parents[module]``) and
    drawn in ``dtype`` where not; and the name of the mode it runs."""
    import torch

    cout = module.weight_q.shape[0]
    dev = module.weight_q.device
    own = parents.get(module, module)
    bias64 = getattr(own, "bias64", None)
    if bias64 is None:
        bias64 = torch.randn(cout, generator=gen, device=dev).to(dtype).to(
            torch.float64)
    scale64 = getattr(own, "scale64", None)
    if scale64 is None:
        scale64 = (torch.rand(cout, generator=gen, device=dev) + 0.5).to(
            dtype).to(torch.float64)
    modes = {"dequantize": {}, "bias": {"bias64": bias64},
             "bias+relu": {"bias64": bias64, "relu": True},
             "affine": {"bias64": bias64, "scale64": scale64}}
    if own is not module:
        return modes, "affine"
    return modes, ("bias+relu" if getattr(module, "act", None) == "relu"
                   else "bias")


def int8_kernel_names():
    from terran_tpu_torch.models import quant

    return quant.QUANTIZE_KERNELS + (quant.EPILOGUE_KERNEL,)


def int8_launch_counts(since=None):
    """{"int_mm": torch._int_mm calls, kernel name: launches} so far, by
    quant_conv's counters (each kernel counted where it launches), less
    ``since``."""
    from terran_tpu_torch.models import quant

    counts = {"int_mm": quant.quant_conv.launches}
    counts.update((name, quant.quant_conv.fused[name])
                  for name in int8_kernel_names())
    if since is not None:
        counts = {name: n - since[name] for name, n in counts.items()}
    return counts


def check_int8_launches(counts, what):
    """Every int8 conv of ``counts`` (int8_launch_counts) took the
    kernels: each kernel launched once a ``torch._int_mm`` call."""
    if counts["int_mm"] < 1 or any(counts[name] != counts["int_mm"]
                                   for name in int8_kernel_names()):
        raise AssertionError(f"{what}: _int_mm calls and kernel launches "
                             f"{counts}, expected each kernel once an int8 "
                             "conv")


def int8_conv_eager(x, weight_q, weight_scale, stride, padding, out_dtype,
                    weight_mat, **epilogue):
    """The eager passes the kernels replace, for their time and launch
    records: quantize_activation, the eager im2col and torch._int_mm,
    epilogue_plain."""
    from terran_tpu_torch.models import quant

    xq, xs = quant.quantize_activation(x)
    acc = quant.conv_int32_int_mm(xq, weight_mat, weight_q.shape[0],
                                  weight_q.shape[-1], stride, padding)
    return quant.epilogue_plain(acc, xs, weight_scale, out_dtype, **epilogue)


def check_int8_conv(x, module, modes, label):
    """The kernels against the eager passes and the plain float64 conv on
    one input: max|x|, xs and every byte of the column matrix (padding
    included) equal to quantize_activation + im2col_int8, the int32
    product to the float64 conv (not where xs is NaN: a NaN has no
    integer there), each epilogue mode's output to epilogue_plain, and
    quant_conv in each mode to quant_conv_plain, each kernel launched once
    by its counter; a NaN equals a NaN. Returns the column matrix and the
    outputs' dims."""
    import torch

    from terran_tpu_torch.models import quant

    wq, ws, wm = module.weight_q, module.weight_scale, module.weight_mat
    cout, _, kernel, _ = wq.shape
    stride, padding = module.stride, module.padding
    cols, scalars, (n, ho, wo) = quant.quantize_im2col(x, kernel, stride,
                                                       padding)
    max_abs, xs = scalars
    xq, xs_eager = quant.quantize_activation(x)
    cols_eager, _ = quant.im2col_int8(xq, kernel, stride, padding)
    acc_plain, xs_plain = quant.quant_conv_int32_plain(x, wq, stride, padding)
    m = n * ho * wo
    acc = torch._int_mm(cols, wm)
    acc_nhwc = acc[:m, :cout].reshape(n, ho, wo, cout)
    checks = {
        "max|x|": same_values(max_abs, x.abs().amax().to(torch.float32)),
        "xs": same_values(xs, xs_eager) and same_values(xs, xs_plain),
        "column matrix": same_values(cols, cols_eager),
        "int32 product": (bool(xs.isnan())
                          or same_values(acc_nhwc, acc_plain)),
    }
    for name, kwargs in modes.items():
        out = quant.dequant_epilogue(acc, scalars, (n, ho, wo), cout, ws,
                                     x.dtype, **kwargs)
        checks[f"{name} epilogue"] = same_values(
            out, quant.epilogue_plain(acc_nhwc, xs_eager, ws, x.dtype,
                                      **kwargs))
        args = (x, wq, ws, stride, padding, x.dtype, wm)
        before = int8_launch_counts()
        out = quant.quant_conv(*args, **kwargs)
        checks[f"{name} launches"] = set(
            int8_launch_counts(before).values()) == {1}
        checks[f"{name} quant_conv"] = same_values(
            out, quant.quant_conv_plain(*args, **kwargs))
    torch.cuda.synchronize()
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"int8 conv {label}: the kernels and the eager "
                             f"passes differ in {failed}")
    return cols, (n, ho, wo)


def int8_conv_phase(arc_params, pose_params, dev, card):
    """Every distinct quantised conv of both trunks at the pipeline's
    shapes, bf16: the kernels of csrc/quant_conv.cu against the eager
    passes and the plain float64 conv on the card (check_int8_conv), then
    an all-zero activation (the 1e-12 floor) and one with a NaN through
    the first conv of each trunk and a 7x7 conv over 185 channels; each
    conv timed through the kernels beside the eager passes, torch._int_mm
    alone, cuDNN's bf16 conv of the same shape and its bounds. Returns the
    rows and the cases, for int8_conv_launches."""
    from functools import partial

    import torch
    import torch.nn.functional as F

    from terran_tpu_torch.models import arcface, quant

    dtype = torch.bfloat16
    rec, pose = int8_models(arc_params, pose_params, dtype, dev)
    parents = {m.conv: m for m in rec.modules()
               if isinstance(m, arcface._Int8ConvAffine)}
    crops, pose_in = int8_pipeline_inputs(dev, dtype)
    groups = {}
    for model_name, model, x in (("arcface", rec, crops),
                                 ("openpose", pose, pose_in)):
        for module, shape in quant_conv_calls(model, x):
            cout, cin, kernel, _ = module.weight_q.shape
            key = (model_name, cin, cout, kernel, module.stride,
                   module.padding, shape)
            groups.setdefault(key, [module, 0])[1] += 1
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows, cases = [], []
    for key, (module, count) in groups.items():
        model_name, cin, cout, kernel, stride, padding, shape = key
        x = torch.randn(shape, generator=gen, device=dev).relu().to(dtype)
        modes, own = int8_epilogues(module, parents, gen, dtype)
        cols, (n, ho, wo) = check_int8_conv(x, module, modes, key)
        wq, ws, wm = module.weight_q, module.weight_scale, module.weight_mat
        args = (x, wq, ws, stride, padding, dtype, wm)
        kernels = partial(quant.quant_conv, *args, **modes[own])
        eager = partial(int8_conv_eager, *args, **modes[own])
        cases.append((key, count, kernels, eager))
        ms = time_ms(kernels)
        eager_ms = time_ms(eager)
        int_mm_ms = time_ms(lambda: torch._int_mm(cols, wm))
        # The same product with the weight matrix row-major: the layout
        # conv_weight_matrix does not take.
        wm_rows = wm.contiguous()
        int_mm_row_major_ms = time_ms(lambda: torch._int_mm(cols, wm_rows))
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_bf16 = wq.to(dtype)
        library_ms = time_ms(lambda: F.conv2d(x_nchw, w_bf16, stride=stride,
                                              padding=padding))
        m, k = n * ho * wo, kernel * kernel * cin
        x_bytes, out_bytes = x.numel() * x.element_size(), m * cout * 2
        bound_ms, bound_by = int8_conv_bound_ms(m, k, cout, x_bytes,
                                                out_bytes, wq.numel())
        # The three kernels' least traffic: the activation read twice, the
        # column matrix written once, the int32 product read once and the
        # output written once.
        kernels_bytes = (2 * x_bytes + cols.numel() + m * wm.shape[1] * 4
                         + out_bytes)
        rows.append({
            "model": model_name, "cin": cin, "cout": cout, "k": kernel,
            "stride": stride, "input": list(shape), "m": m,
            "k_padded": cols.shape[1], "n_padded": wm.shape[1],
            "epilogue": own, "exact": True, "max_abs_err": 0.0,
            "ms": ms, "eager_ms": eager_ms, "int_mm_ms": int_mm_ms,
            "int_mm_row_major_ms": int_mm_row_major_ms,
            "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "kernels_bound_ms": 1e3 * kernels_bytes / PEAK_BYTES,
            "im2col_bytes": cols.numel() + m * wm.shape[1] * 4,
            "launches_per_batch": count,
        })
        log(f"int8 conv == eager == plain ({card}): {model_name} {cin}->"
            f"{cout} k{kernel} s{stride} on {tuple(shape)} (M={m}, K={k}->"
            f"{cols.shape[1]}, N={cout}->{wm.shape[1]}, {own}) x{count} a "
            f"batch: kernels {ms:.4f} ms against eager {eager_ms:.4f} "
            f"(_int_mm {int_mm_ms:.4f}, row-major weights "
            f"{int_mm_row_major_ms:.4f}), cuDNN bf16 {library_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}), the three kernels' "
            f"bytes {rows[-1]['kernels_bound_ms']:.5f} ms, im2col "
            f"{rows[-1]['im2col_bytes'] / 1e6:.1f} MB")
    edge = [(key, module) for key, (module, _) in groups.items()
            if key[1] in (3, 185)]
    for key, module in edge:
        modes, _ = int8_epilogues(module, parents, gen, dtype)
        zeros = torch.zeros(key[-1], dtype=dtype, device=dev)
        check_int8_conv(zeros, module, modes, f"{key} all zero")
        _, (_, xs), _ = quant.quantize_im2col(zeros, *key[3:6])
        nan = torch.randn(key[-1], generator=gen, device=dev).to(dtype)
        nan[-1, 1, 2, -1] = float("nan")
        check_int8_conv(nan, module, modes, f"{key} with a NaN")
        _, (_, xs_nan), _ = quant.quantize_im2col(nan, *key[3:6])
        if not (xs.item() == float(torch.tensor(quant.SCALE_FLOOR))
                and bool(xs_nan.isnan())):
            raise AssertionError(f"int8 conv {key}: xs {xs.item()} of zeros, "
                                 f"{xs_nan.item()} with a NaN")
    log(f"int8 conv edge activations ({card}): an all-zero activation (xs "
        f"= float32(1e-12)) and one with a NaN (xs NaN) equal to the eager "
        f"passes through {len(edge)} convs (cin 3 and 185, the 7x7)")
    for name in ("arcface", "openpose"):
        rows_of = [r for r in rows if r["model"] == name]

        def total(field, rows_of=rows_of):
            return sum(r[field] * r["launches_per_batch"] for r in rows_of)

        log(f"int8 {name} at the pipeline's shapes: "
            f"{sum(r['launches_per_batch'] for r in rows_of)} convs a batch, "
            f"kernels {total('ms'):.3f} ms against eager "
            f"{total('eager_ms'):.3f} ms, _int_mm {total('int_mm_ms'):.3f} "
            f"ms, cuDNN bf16 {total('library_ms'):.3f} ms, bound "
            f"{total('bound_ms'):.4f} ms, the three kernels' bytes "
            f"{total('kernels_bound_ms'):.4f} ms, im2col "
            f"{total('im2col_bytes') / 1e9:.3f} GB")
    return rows, cases


def int8_conv_launches(cases, card, calls=5, attempts=3):
    """Device records and device ms of one call of each distinct int8
    conv through the kernels and through the eager passes, from
    torch.profiler's records of ``calls`` calls (phase 6). Each profiled
    call of the kernels must launch each kernel once by its counter, and
    the profiler must record each kernel at least ``calls`` - 1 times. It
    loses a record now and then (PERF.md section 7), so a conv short of
    that is profiled again, up to ``attempts`` times, each short attempt
    logged. Returns {key: {"kernels": [records, ms], "eager": [records,
    ms], "kernel_ms": {kernel: ms a call}, "records": {kernel: records},
    "attempts": n, "per_batch": the conv's calls a batch}}."""
    names = int8_kernel_names()
    out = {}
    for key, count, kernels, eager in cases:
        for attempt in range(1, attempts + 1):
            counts = {}
            before = int8_launch_counts()
            k_rec, k_ms, by_name = profile_call(kernels, calls, counts)
            launched = int8_launch_counts(before)
            # profile_call makes two calls besides the profiled ones.
            if set(launched.values()) != {calls + 2}:
                raise AssertionError(f"int8 conv {key}: {launched} "
                                     f"launches over {calls + 2} calls")
            records = {name: sum(n for kernel, n in counts.items()
                                 if name in kernel) for name in names}
            if min(records.values()) >= calls - 1:
                break
            log(f"int8 conv launches ({card}): {key}, attempt {attempt}: "
                f"the profiler recorded {records} of {calls} calls, "
                f"{launched} launched")
        else:
            raise AssertionError(f"int8 conv {key}: the profiler recorded "
                                 f"{records} of {calls} calls in each of "
                                 f"{attempts} attempts")
        e_rec, e_ms, _ = profile_call(eager, calls)
        kernel_ms = {name: sum(ms for kernel, ms in by_name.items()
                               if name in kernel) for name in names}
        out[str(key)] = {"kernels": [k_rec, k_ms], "eager": [e_rec, e_ms],
                         "kernel_ms": kernel_ms, "records": records,
                         "attempts": attempt, "per_batch": count}
        log(f"int8 conv launches ({card}): {key[0]} {key[1]}->{key[2]} "
            f"k{key[3]} s{key[4]} on {key[6]}: kernels {k_rec:g} device "
            f"records a call (memset included), {k_ms:.4f} device ms "
            f"({', '.join(f'{n} {ms:.4f}' for n, ms in kernel_ms.items())}"
            f"; records {records} of {calls}); eager {e_rec:g}, "
            f"{e_ms:.4f} ms")
    return out


def int8_kernels_entry(rows, launches, pipe_int8, card):
    """The kernels line's entry of csrc/quant_conv.cu: sums over a
    pipeline batch's int8 convs (each distinct conv's figures times its
    calls a batch) of int8_conv_phase's rows (whole conv calls: the
    kernels and _int_mm, against the eager passes, bf16 cuDNN and the
    kernels' byte bound) and int8_conv_launches' profiled device ms of
    each kernel, and the main path's launches a batch by the counters."""
    def total(field):
        return sum(r[field] * r["launches_per_batch"] for r in rows)

    names = int8_kernel_names()
    kernel_ms = {name: sum(v["kernel_ms"][name] * v["per_batch"]
                           for v in launches.values()) for name in names}
    per_batch = pipe_int8["launches_per_batch"]
    return {
        "name": "quant_conv",
        "route": "cuda",
        "source": "terran_tpu_torch/csrc/quant_conv.cu",
        "replaces": "terran_tpu/models/quant.py:57 (XLA's fusion around "
                    "its int8 conv; no Pallas kernel)",
        "launches": sum(pipe_int8["launches"][name] for name in names),
        "pipeline_batches": pipe_int8["batches"],
        "pipeline_launches_per_batch": {name: per_batch[name]
                                        for name in names},
        "pipeline_int_mm_per_batch": per_batch["int_mm"],
        "convs_checked": len(rows),
        "max_abs_err": 0.0,
        "exact": all(r["exact"] for r in rows),
        "ms": total("ms"),
        "kernel_ms": sum(kernel_ms.values()),
        "kernel_ms_by_name": kernel_ms,
        "int_mm_ms": total("int_mm_ms"),
        "plain_ms": total("eager_ms"),
        "bound_ms": total("kernels_bound_ms"),
        "bound_by": "bytes",
        "library_ms": None,
        "cudnn_bf16_ms": total("library_ms"),
        "card": card,
    }


def int8_float32_phase(arc_params, pose_params, dev, card):
    """float32, TF32 off: Int8FaceResNet100 on 8 seeded crops and
    Int8BodyPoseModel on one 184-side frame through the kernels equal the
    same modules through the plain float64 convs and eager epilogues on
    the card (quant_conv_kernels swapped for quant_conv_plain); the
    embedding cosine of int8 against the float32 FaceResNet100."""
    import numpy as np
    import torch

    from terran_tpu_torch.models import arcface, quant
    from terran_tpu_torch.models.arcface import normalize_embeddings
    from terran_tpu_torch.ops.pose_decode import normalize_images
    from terran_tpu_torch.ops.resize import resized_shape

    rec, pose = int8_models(arc_params, pose_params, torch.float32, dev)
    rng = np.random.default_rng(SEED + 7)
    crops = torch.as_tensor(rng.integers(0, 256, (8, CROP, CROP, 3)),
                            dtype=torch.float32, device=dev)
    pose_h, pose_w, _ = resized_shape(*FRAME, POSE_SIDE)
    frame = normalize_images(torch.as_tensor(
        rng.integers(0, 256, (1, pose_h, pose_w, 3), dtype=np.uint8),
        device=dev))

    def run():
        with torch.inference_mode():
            return rec(crops), pose(frame)

    before = int8_launch_counts()
    feats, (paf, heat) = run()
    counts = int8_launch_counts(before)
    launches = counts["int_mm"]
    kernels = quant.quant_conv_kernels
    quant.quant_conv_kernels = quant.quant_conv_plain
    try:
        feats_plain, (paf_plain, heat_plain) = run()
    finally:
        quant.quant_conv_kernels = kernels
    torch.cuda.synchronize()
    if launches != 103 + 92:
        raise AssertionError(f"{launches} _int_mm calls in one forward of "
                             "each int8 trunk, expected 103 + 92")
    check_int8_launches(counts, "int8 float32 trunks")
    for name, got, ref in (("embedding features", feats, feats_plain),
                           ("pafs", paf, paf_plain),
                           ("heatmaps", heat, heat_plain)):
        if not torch.equal(got, ref):
            err = float((got - ref).abs().max())
            raise AssertionError(f"int8 {name}: the _int_mm path and the "
                                 f"plain convs differ by {err}")
    native = arcface.FaceResNet100()
    native.load_state_dict(arc_params)
    with torch.inference_mode():
        ref = normalize_embeddings(native.to(dev).eval()(crops))
    cosine = (normalize_embeddings(feats) * ref).sum(-1)
    log(f"int8 float32 ({card}): {launches} _int_mm calls, all through "
        f"the kernels; embeddings "
        f"{tuple(feats.shape)}, pafs {tuple(paf.shape)} and heatmaps "
        f"{tuple(heat.shape)} equal to the plain convs on the card; "
        f"embedding cosine int8 vs float32 FaceResNet100 min "
        f"{float(cosine.min()):.6f} mean {float(cosine.mean()):.6f}")
    if not bool((cosine > 0.98).all()):
        raise AssertionError(f"int8 embeddings far from float32: {cosine}")
    return {"int_mm_calls": launches, "kernel_launches": counts,
            "equal_to_plain": True,
            "embedding_cosine_min": float(cosine.min()),
            "embedding_cosine_mean": float(cosine.mean())}


def int8_task_phase(arc_params, pose_params, frames, rng, card, native_ms):
    """Both task APIs with 'int8', bf16, on ``frames``: ms a call beside
    the native calls of this run, the _int_mm calls and kernel launches
    they made."""
    import numpy as np

    from terran_tpu_torch.face import Recognition
    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.pose import Estimation

    pose = Estimation(params=pose_params, pose_precision="int8")
    fp.find_peaks_fused.launches = 0
    before = int8_launch_counts()
    people, warm_s, pose_ms = timed_calls(lambda: pose(frames))
    pose_launches = dict(int8_launch_counts(before),
                         fused_peaks=fp.find_peaks_fused.launches)
    if min(pose_launches.values()) < 1 + TIMED_CALLS:
        raise AssertionError(f"int8 pose task: launches {pose_launches}")
    check_int8_launches(pose_launches, "int8 pose task")
    assert len(people) == len(frames)
    for frame_people in people:
        for person in frame_people:
            assert person["keypoints"].shape == (18, 3)
            assert np.isfinite(person["score"])

    recognition = Recognition(params=arc_params, embed_precision="int8")
    face_lists = synthetic_faces(rng, len(frames))
    before = int8_launch_counts()
    feats, rec_warm_s, rec_ms = timed_calls(
        lambda: recognition(list(frames), face_lists))
    rec_counts = int8_launch_counts(before)
    check_int8_launches(rec_counts, "int8 recognition task")
    rec_launches = rec_counts["int_mm"]
    for frame_feats in feats:
        assert frame_feats.shape == (FACES_PER_FRAME, 512)
        if not np.allclose(np.linalg.norm(frame_feats, axis=1), 1.0,
                           rtol=1e-5):
            raise AssertionError("int8 embeddings are not unit vectors")
    log(f"int8 task APIs ({card}), bf16, {len(frames)} 1080p frames: pose "
        f"{pose_ms:.2f} ms a call (native {native_ms['pose']:.2f}; warm "
        f"{warm_s:.3f} s; launches {pose_launches}); recognition of "
        f"{FACES_PER_FRAME} faces a frame {rec_ms:.2f} ms a call (native "
        f"{native_ms['recognition']:.2f}; warm {rec_warm_s:.3f} s; "
        f"{rec_launches} _int_mm calls, all through the kernels)")
    return {"pose_ms": pose_ms, "recognition_ms": rec_ms,
            "native_pose_ms": native_ms["pose"],
            "native_recognition_ms": native_ms["recognition"],
            "pose_launches": pose_launches,
            "recognition_int_mm_calls": rec_launches,
            "recognition_launches": rec_counts}


def pipeline_int8_phase(params, batches, card, native):
    """The main path of this slice: the pipeline's device plan with both
    int8 trunks at bench.py's configuration, bf16, right after the native
    pipeline: warmup, one batch, a dispatch under the sync check, then
    PIPE_SWEEPS timed sweeps with the counts set to 0 before them: each
    hand-written kernel exactly 2 launches a batch, the _int_mm calls a
    batch."""
    import torch

    from terran_tpu_torch.models import quant
    from terran_tpu_torch.models.arcface import Int8FaceResNet100
    from terran_tpu_torch.models.openpose import Int8BodyPoseModel
    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops import nms
    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    pipe = PerceptionPipeline(**pipeline_kwargs(
        params, timer=timer, embed_precision="int8", pose_precision="int8"))
    if not (isinstance(pipe.rec_model, Int8FaceResNet100)
            and isinstance(pipe.pose_model, Int8BodyPoseModel)
            and pipe.rec_model.compute_dtype == torch.bfloat16
            and pipe.pose_model.compute_dtype == torch.bfloat16):
        raise AssertionError("the int8 pipeline must run both int8 trunks "
                             "in bf16")
    if pipe.rec_params["initial.conv.weight_q"].dtype != torch.int8:
        raise AssertionError("rec_params must hold the quantised weights")
    start = time.perf_counter()
    programs = pipe.warmup(BATCH, *FRAME)
    warm_s = time.perf_counter() - start
    check_pipeline_result(pipe.process_batch(batches[0]), BATCH, PIPE_CONFIG)
    frames_dev = pipe.put_frames(batches[0])
    torch.cuda.set_sync_debug_mode("error")
    try:
        dispatched = pipe.dispatch_batch(frames_dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check_pipeline_result(pipe.finalize_batch(*dispatched), BATCH,
                          PIPE_CONFIG)
    for _ in pipe.process_stream(batches[:2], depth=PIPE_DEPTH):
        pass

    timer.reset()
    fp.find_peaks_fused.launches = 0
    nms.suppress.launches = 0
    quant.quant_conv.launches = 0
    quant.quant_conv.fused.clear()
    fps = []
    for _ in range(PIPE_SWEEPS):
        start = time.perf_counter()
        outs = list(pipe.process_stream(batches, depth=PIPE_DEPTH))
        fps.append(BATCH * PIPE_BATCHES / (time.perf_counter() - start))
        for out in outs:
            check_pipeline_result(out, BATCH, PIPE_CONFIG)
    swept = PIPE_SWEEPS * PIPE_BATCHES
    launches = {"fused_peaks": fp.find_peaks_fused.launches,
                "nms": 2 * nms.suppress.launches,
                **int8_launch_counts()}
    for name in ("fused_peaks", "nms"):
        if launches[name] != 2 * swept:
            raise AssertionError(f"the int8 pipeline launched {name}'s "
                                 f"kernels {launches[name]} times over "
                                 f"{swept} batches, expected 2 a batch")
    if launches["int_mm"] < 92 * swept:
        raise AssertionError(f"{launches['int_mm']} _int_mm calls over "
                             f"{swept} batches: the int8 trunks did not run")
    check_int8_launches(launches, f"the int8 pipeline over {swept} batches")
    fps_median = sorted(fps)[len(fps) // 2]
    summary = timer.summary()
    per_batch = {name: count / swept for name, count in launches.items()}
    log(f"int8 pipeline ({card}): {PIPE_SWEEPS} sweeps of {PIPE_BATCHES} "
        f"batches x {BATCH} x {FRAME[0]}x{FRAME[1]}, {PIPE_CONFIG}, bf16, "
        f"embed and pose int8: warmup {programs} programs in {warm_s:.3f} "
        f"s; frames/s per sweep " + ", ".join(f"{f:.2f}" for f in fps)
        + f"; median {fps_median:.2f} frames/s = "
        f"{BATCH * 1e3 / fps_median:.2f} ms/batch, against native "
        f"{native['fps_median']:.2f} in this run "
        f"({fps_median / native['fps_median']:.3f}x); launches per batch "
        f"{per_batch}")
    log("int8 pipeline stage timer (host wall time, the sweeps): "
        + json.dumps(summary))
    return {"fps": fps, "fps_median": fps_median,
            "batch_ms": BATCH * 1e3 / fps_median,
            "native_fps_median": native["fps_median"],
            "native_fps": native["fps"],
            "ratio_to_native": fps_median / native["fps_median"],
            "launches": launches, "launches_per_batch": per_batch,
            "batches": swept, "warmup_programs": programs,
            "stages": summary}


def cli_run(home, *args):
    """``python3 -m terran_tpu_torch.cli checkpoint <args>`` in a process of
    its own against the checkpoint home ``home``: (stdout, seconds). A
    nonzero exit fails the run."""
    env = dict(os.environ, TERRAN_TPU_HOME=str(home),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    start = time.perf_counter()
    result = subprocess.run(
        [sys.executable, "-m", "terran_tpu_torch.cli", "checkpoint", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - start
    if result.returncode != 0:
        raise AssertionError(f"checkpoint {' '.join(args)}: exit "
                             f"{result.returncode}\n{result.stdout}"
                             f"{result.stderr}")
    return result.stdout, seconds


def faces_key(faces_per_frame):
    return [[(face["bbox"].tolist(), face["landmarks"].tolist(),
              float(face["score"])) for face in faces]
            for faces in faces_per_frame]


def people_key(people_per_frame):
    return [[(person["keypoints"].tolist(), float(person["score"]))
             for person in people] for people in people_per_frame]


def image_loading_check(frame):
    """``open_image`` and ``resolve_images`` where Pillow imports: a PNG of
    ``frame`` reads back equal, and a tree holding it twice (once nested)
    and a file that is no image resolves to the two PNGs in one batch."""
    import numpy as np
    from PIL import Image

    from terran_tpu_torch.io import open_image, resolve_images

    root = STORE_DIR / "images"
    (root / "nested").mkdir(parents=True)
    for path in (root / "a.png", root / "nested" / "b.png"):
        Image.fromarray(frame).save(path)
    (root / "notes.txt").write_text("not an image")
    if not np.array_equal(open_image(str(root / "a.png")), frame):
        raise AssertionError("open_image: the PNG does not read back equal")
    batches = list(resolve_images(root, batch_size=4))
    if batches != [[root / "a.png", root / "nested" / "b.png"]]:
        raise AssertionError(f"resolve_images: {batches}")
    return "open_image and resolve_images ran with Pillow"


def store_phase(raw, params, frames, batch, face_rng, card):
    """The user's start on the card: the store, then the default entry
    points, then both kernels.

    - The seeded reference-format state dicts (``raw``, by family) are
      written as .pth files under build/store/; then, each in a process of
      its own against a fresh checkpoint home there, ``python3 -m
      terran_tpu_torch.cli checkpoint convert <id> <pth>`` for the three,
      ``checkpoint list`` and ``checkpoint info <id>``: each exits 0 and
      names the store's file (seconds a convert logged).
    - ``Detection()``, ``Recognition()`` and ``Estimation()`` with no
      ``params=`` on ``frames``, and ``PerceptionPipeline(**PIPE_CONFIG)``
      on ``batch``, bf16 on the card, each equal bit for bit (deterministic
      cuDNN) to the same entry point given ``params=``; the NMS and peak
      kernels launched in each that has them (counts set to 0 just before
      each call and read just after).
    - ``examples/torch_streams.py --synthetic 2 --frames 16 --batch-size
      8`` in a process of its own on the card: exit 0, 32 frames over 2
      streams.
    - Where Pillow or pycairo imports, ``vis_faces``/``vis_poses`` on the
      default entry points' outputs of one frame return its shape with
      pixels changed, and where Pillow imports ``image_loading_check``
      runs; elsewhere ``vis_faces`` raises ImportError, and the phase logs
      that image loading and drawing cannot run there.
    - ``checkpoint delete`` of RetinaFace, then ``checkpoint info`` says
      NOT_DOWNLOADED. (Download is not driven: the machine has no
      network.)

    Returns the fields of the ``store`` line."""
    import shutil

    import numpy as np
    import torch

    from terran_tpu_torch import vis
    from terran_tpu_torch.face import Detection, Recognition
    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops import nms
    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.pose import Estimation

    shutil.rmtree(STORE_DIR, ignore_errors=True)
    STORE_DIR.mkdir(parents=True)
    home = STORE_DIR / "home"
    store = home / "checkpoints"
    convert_s = {}
    for family, checkpoint_id in STORE_IDS.items():
        pth = STORE_DIR / f"{family}.pth"
        torch.save({k: torch.as_tensor(np.ascontiguousarray(v))
                    for k, v in raw[family].items()}, pth)
        out, convert_s[family] = cli_run(home, "convert", checkpoint_id,
                                         str(pth))
        if f"Converted to {store / checkpoint_id}.npz." not in out:
            raise AssertionError(f"convert {checkpoint_id}: {out!r}")
        log(f"store: checkpoint convert {checkpoint_id} ({family}, "
            f"{pth.stat().st_size} bytes of .pth) exit 0 in "
            f"{convert_s[family]:.2f} s: {out.strip()}")
    out, _ = cli_run(home, "list")
    rows = {cid: [line for line in out.splitlines() if f"({cid})" in line]
            for cid in STORE_IDS.values()}
    if any(len(row) != 1 or not row[0].endswith("  DOWNLOADED")
           for row in rows.values()):
        raise AssertionError(f"checkpoint list: {out!r}")
    for checkpoint_id in STORE_IDS.values():
        out, _ = cli_run(home, "info", checkpoint_id)
        if f"DOWNLOADED (at `{store / checkpoint_id}.npz`)" not in out:
            raise AssertionError(f"checkpoint info {checkpoint_id}: {out!r}")
    log(f"store: checkpoint list and info exit 0, each entry DOWNLOADED "
        f"under {store}")

    rf_params, arc_params, pose_params = params
    launches = {}
    default_ms = {}

    def counted(name, call):
        fp.find_peaks_fused.launches = 0
        nms.suppress.launches = 0
        start = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        default_ms[name] = 1e3 * (time.perf_counter() - start)
        launches[name] = {"fused_peaks": fp.find_peaks_fused.launches,
                          "nms": 2 * nms.suppress.launches}
        return out

    saved_home = os.environ["TERRAN_TPU_HOME"]
    os.environ["TERRAN_TPU_HOME"] = str(home)
    torch.backends.cudnn.deterministic = True
    try:
        explicit = Detection(params=rf_params)
        default = Detection()
        if (default.model.device.type != torch.device(DEVICE).type
                or default.model.model.compute_dtype != torch.bfloat16):
            raise AssertionError("Detection() must run bf16 on the card")
        expected = explicit(frames)
        faces = counted("Detection()", lambda: default(frames))
        if faces_key(faces) != faces_key(expected):
            raise AssertionError("Detection() differs from its params= twin")
        del explicit, default

        face_lists = synthetic_faces(face_rng, len(frames))
        expected = Recognition(params=arc_params)(list(frames), face_lists)
        default = Recognition()
        if default.model.model.compute_dtype != torch.bfloat16:
            raise AssertionError("Recognition() must run bf16")
        feats = counted("Recognition()",
                        lambda: default(list(frames), face_lists))
        if not all(np.array_equal(a, b) for a, b in zip(feats, expected)):
            raise AssertionError("Recognition() differs from its params= "
                                 "twin")
        del default

        expected = Estimation(params=pose_params)(frames)
        default = Estimation()
        if default.model.model.compute_dtype != torch.bfloat16:
            raise AssertionError("Estimation() must run bf16")
        people = counted("Estimation()", lambda: default(frames))
        if people_key(people) != people_key(expected):
            raise AssertionError("Estimation() differs from its params= "
                                 "twin")
        del default

        expected = PerceptionPipeline(
            **pipeline_kwargs(params)).process_batch(batch)
        default = PerceptionPipeline(**PIPE_CONFIG)
        if default.device.type != torch.device(DEVICE).type:
            raise AssertionError(f"PerceptionPipeline() on {default.device}")
        got = counted("PerceptionPipeline()",
                      lambda: default.process_batch(batch))
        assert_same_pipeline(got, expected,
                             "PerceptionPipeline() vs its params= twin")
        del default
    finally:
        torch.backends.cudnn.deterministic = False
        os.environ["TERRAN_TPU_HOME"] = saved_home
    for name, kernels in (("Detection()", ("nms",)),
                          ("Estimation()", ("fused_peaks",)),
                          ("PerceptionPipeline()", ("nms", "fused_peaks"))):
        for kernel in kernels:
            if launches[name][kernel] < 2:
                raise AssertionError(f"{name} did not launch the {kernel} "
                                     "kernels")
    for name in launches:
        log(f"store: {name} from the store equals its params= twin bit for "
            f"bit (bf16, {card}); one call {default_ms[name]:.2f} ms; "
            f"launches {launches[name]}")

    env = dict(os.environ, TERRAN_TPU_HOME=str(home),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO), os.environ.get("PYTHONPATH", "")]))
    args = ["--synthetic", str(STORE_STREAMS), "--frames",
            str(STORE_STREAM_FRAMES), "--batch-size", str(BATCH)]
    start = time.perf_counter()
    result = subprocess.run(
        [sys.executable, str(REPO / "examples" / "torch_streams.py"), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    streams_s = time.perf_counter() - start
    lines = result.stdout.splitlines()
    total = STORE_STREAMS * STORE_STREAM_FRAMES
    if (result.returncode != 0 or not lines
            or not lines[0].startswith(f"{total} frames over "
                                       f"{STORE_STREAMS} streams in ")
            or lines[1:] != [f"  stream {i}: {STORE_STREAM_FRAMES} frames"
                             for i in range(STORE_STREAMS)]):
        raise AssertionError(f"examples/torch_streams.py {' '.join(args)}: "
                             f"exit {result.returncode}\n{result.stdout}"
                             f"{result.stderr[-4000:]}")
    log(f"store: examples/torch_streams.py {' '.join(args)} exit 0 in "
        f"{streams_s:.1f} s of process time: {lines[0]}")

    leaf = {name: importable(name) for name in ("PIL", "cairo")}
    if leaf["PIL"] != "no" or leaf["cairo"] != "no":
        drawn = {"vis_faces": vis.vis_faces(frames[0], faces[0]),
                 "vis_poses": vis.vis_poses(frames[0], people[0])}
        visible = any(person["keypoints"][:, 2].any()
                      for person in people[0])
        for name, image in drawn.items():
            if image.shape != frames[0].shape:
                raise AssertionError(f"{name}: shape {image.shape}")
            if (name == "vis_faces" or visible) \
                    and not (image != frames[0]).any():
                raise AssertionError(f"{name} drew nothing")
        vis_status = f"ran with {vis.backend().__name__}"
        if leaf["PIL"] != "no":
            vis_status += "; " + image_loading_check(frames[0])
        log(f"store: the leaf group on this machine: vis_faces and "
            f"vis_poses {vis_status}")
    else:
        try:
            vis.vis_faces(frames[0], faces[0])
        except ImportError as exc:
            vis_status = f"ImportError: {exc}"
        else:
            raise AssertionError("vis_faces ran without Pillow or pycairo")
        log("store: Pillow and pycairo do not import on this machine, so "
            "open_image, resolve_images, display_image, vis_faces and "
            f"vis_poses cannot run here (vis_faces raised {vis_status})")

    checkpoint_id = STORE_IDS["retinaface"]
    out, _ = cli_run(home, "delete", checkpoint_id)
    if f"Checkpoint `{checkpoint_id}` deleted successfully." not in out:
        raise AssertionError(f"checkpoint delete: {out!r}")
    out, _ = cli_run(home, "info", checkpoint_id)
    if ("Status        NOT_DOWNLOADED" not in out
            or (store / f"{checkpoint_id}.npz").exists()):
        raise AssertionError(f"checkpoint info after delete: {out!r}")
    log(f"store: checkpoint delete {checkpoint_id} exit 0; info then says "
        "NOT_DOWNLOADED")
    shutil.rmtree(STORE_DIR)
    return {"convert_s": convert_s, "launches": launches,
            "default_call_ms": default_ms,
            "streams_example": {"args": args, "process_s": streams_s,
                                "line": lines[0]},
            "vis": vis_status,
            "store_launches": {
                kernel: sum(counts[kernel] for counts in launches.values())
                for kernel in ("fused_peaks", "nms")}}


def observability_phase(params, batches, card):
    """The package's runtime and tracing names on the card, after every
    timed phase (the profiler slows later launches in its process):
    ``platform()`` and ``available_devices()``; a float32 default policy
    reaching a ``Detection`` built with no ``compute_dtype``; then
    ``start_trace``, TRACED_BATCHES batches of a warm pipeline at
    bench.py's configuration each inside ``trace("pipeline_batch")``,
    ``stop_trace``. The written ``*.pt.trace.json`` must hold the region
    and each of the four kernels, replayed from the pipeline's CUDA graphs,
    2 launches of each kernel pair a batch, and the global timer must count
    the region once a batch. A second ``start_trace`` while one runs must
    raise."""
    import shutil

    import torch

    from terran_tpu_torch.face import Detection
    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.runtime import (
        Policy, available_devices, default_policy, platform,
        set_default_policy,
    )
    from terran_tpu_torch.utils.profiling import (
        global_timer, start_trace, stop_trace, trace,
    )

    if platform() != "gpu":
        raise AssertionError(f"platform() is {platform()!r}, not 'gpu'")
    devices = available_devices()
    if devices != [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]:
        raise AssertionError(f"available_devices() is {devices}")

    saved = default_policy()
    set_default_policy(Policy(compute_dtype=torch.float32))
    detector = Detection(params=params[0])
    set_default_policy(saved)
    weights = {p.dtype for p in detector.model.model.parameters()}
    if weights != {torch.float32}:
        raise AssertionError(f"a float32 default policy built {weights} "
                             "weights")
    del detector

    pipe = PerceptionPipeline(**pipeline_kwargs(params))
    pipe.warmup(BATCH, *FRAME)
    for batch in batches:
        check_pipeline_result(pipe.process_batch(batch), BATCH, PIPE_CONFIG)
    torch.cuda.synchronize()
    untraced_ms = []
    for batch in batches:
        start = time.perf_counter()
        pipe.process_batch(batch)
        torch.cuda.synchronize()
        untraced_ms.append(1e3 * (time.perf_counter() - start))

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    timer = global_timer()
    counted = timer.counts.get("pipeline_batch", 0)
    timed = timer.times.get("pipeline_batch", 0.0)
    traced_ms = []
    start_trace(TRACE_DIR)
    for batch in batches:
        start = time.perf_counter()
        with trace("pipeline_batch"):
            out = pipe.process_batch(batch)
            torch.cuda.synchronize()
        traced_ms.append(1e3 * (time.perf_counter() - start))
        check_pipeline_result(out, BATCH, PIPE_CONFIG)
    try:
        start_trace(TRACE_DIR / "second")
    except RuntimeError as exc:
        double_start = str(exc)
    else:
        raise AssertionError("a second start_trace did not raise")
    stop_trace()
    regions = timer.counts["pipeline_batch"] - counted
    region_ms = 1e3 * (timer.times["pipeline_batch"] - timed)
    if regions != len(batches):
        raise AssertionError(f"the global timer counted {regions} regions "
                             f"over {len(batches)} traced batches")

    (path,) = TRACE_DIR.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    annotated = sum(1 for e in events if e.get("name") == "pipeline_batch"
                    and e.get("cat") == "user_annotation")
    kernels = {name: {"events": 0, "device_ms": 0.0} for name in TRACE_KERNELS}
    device_events, device_ms = 0, 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        device_events += 1
        device_ms += e.get("dur", 0) / 1e3
        # "(anonymous namespace)::scan_kernel(float const*, ...)"
        name = re.search(r"(\w+)\(", e.get("name", ""))
        name = name.group(1) if name else e.get("name")
        if name in kernels:
            kernels[name]["events"] += 1
            kernels[name]["device_ms"] += e.get("dur", 0) / 1e3
    missing = [name for name, k in kernels.items() if not k["events"]]
    if annotated < 1 or missing:
        raise AssertionError(f"the trace {path.name} holds "
                             f"{annotated} pipeline_batch regions and no "
                             f"event of {missing}")
    # The warm pipeline replays CUDA graphs, which the kernels' Python
    # counters do not see: the launches are the trace's kernel records.
    launches = {"fused_peaks": (kernels["scan_kernel"]["events"]
                                + kernels["merge_kernel"]["events"]),
                "nms": (kernels["mask_kernel"]["events"]
                        + kernels["sweep_kernel"]["events"])}
    check_launches(launches, len(batches), "the traced batches")
    result = {
        "platform": platform(), "available_devices": [str(d) for d in devices],
        "float32_policy_weights": sorted(str(w) for w in weights),
        "trace_file": path.name, "trace_file_bytes": path.stat().st_size,
        "trace_events": len(events), "kernel_events": device_events,
        "kernel_device_ms": device_ms,
        "region_events": annotated, "kernels": kernels,
        "traced_batches": len(batches),
        "region_host_ms_global_timer": region_ms,
        "traced_batch_host_ms": traced_ms,
        "untraced_batch_host_ms": untraced_ms,
        "launches": launches, "double_start": double_start,
    }
    log(f"observability ({card}): platform {platform()!r}, "
        f"available_devices {result['available_devices']}, a float32 "
        f"default policy built float32 weights; the trace of "
        f"{len(batches)} pipeline batches: {path.name}, "
        f"{result['trace_file_bytes']} bytes, {len(events)} events, "
        f"{device_events} kernel events ({device_ms:.2f} ms of kernels), "
        + ", ".join(f"{name} {k['events']} ({k['device_ms']:.4f} ms)"
                    for name, k in kernels.items())
        + "; pipeline_batch host ms traced "
        + ", ".join(f"{t:.2f}" for t in traced_ms)
        + " (global timer %.2f in all), untraced " % region_ms
        + ", ".join(f"{t:.2f}" for t in untraced_ms)
        + f"; launches {launches}; a second start_trace raised: "
        f"{double_start}")
    return result


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import numpy as np

    from terran_tpu_torch.face.detection import RetinaFaceDetector
    from terran_tpu_torch.models import quant
    from terran_tpu_torch.ops import conv_epilogue as ce
    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.ops import nms
    from terran_tpu_torch.pose import Estimation
    from terran_tpu_torch.pose.openpose import OpenPoseEstimator
    from terran_tpu_torch.utils import cuda_build
    from terran_tpu_torch.utils.convert import (
        convert_arcface, convert_openpose, convert_retinaface,
    )
    from torch_oracle import (
        random_arcface_state_dict, random_openpose_state_dict,
        random_retinaface_state_dict,
    )

    dev = torch.device(DEVICE)
    # The checkpoint registry's home lives in the checkout's build dir.
    os.environ["TERRAN_TPU_HOME"] = str(REPO / "build" / "terran-home")

    # 1. The card.
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    env = environment_phase()

    # 2. Build, one nvcc per source, all started together.
    start = time.perf_counter()
    sources = ("fused_peaks.cu", "nms.cu", "quant_conv.cu",
               "conv_epilogue.cu")
    cuda_build.load_libraries(*sources)
    fp._library()
    nms._library()
    quant._library()
    ce._library()
    nvcc_s = ", ".join(f"{name} {cuda_build.build_seconds.get(name, 0.0):.2f} s"
                       for name in sources)
    log(f"build: fused_peaks.cu (scan + merge kernels), nms.cu (mask + "
        f"sweep kernels), quant_conv.cu (absmax, quantize_im2col, "
        f"dequant_epilogue) and conv_epilogue.cu in {time.perf_counter() - start:.2f} s (nvcc "
        f"{nvcc_s}; 0 = cached)")
    native_s = native_phase()

    # 3. Kernel vs plain version on the card.
    rng = np.random.default_rng(SEED)
    raw = {"openpose": random_openpose_state_dict(rng)}
    state_dict = convert_openpose(raw["openpose"])
    frames = rng.integers(0, 256, (BATCH,) + FRAME + (3,), dtype=np.uint8)

    model_est = OpenPoseEstimator(params=state_dict)
    resized, _ = model_est._resize_in(frames)
    from terran_tpu_torch.ops.pose_decode import normalize_images

    with torch.inference_mode():
        paf, heat = model_est.model(
            normalize_images(resized).to(model_est.model.compute_dtype)
        )
    heat19 = heat.float()
    strided = heat19[..., :18]  # the pose path's own view, not a copy
    main_heat = strided.contiguous()
    n, h, w, parts = main_heat.shape
    k_main = model_est.max_peaks
    k_pipe = PIPE_CONFIG["max_peaks"]
    log(f"main-path heatmaps: {tuple(main_heat.shape)} -> "
        f"{n * parts} planes of {h}x{w}, K={k_main}")

    plateau = np.full((12, 14, 2), 0.9, np.float32)
    # 0.5 and the dyadic taps upsample exactly: one plateau.
    whole_plane = np.full((1, h, w, 1), 0.5, np.float32)
    piece = np.zeros((16, 26, 1), np.float32)
    piece[4, 10:14, 0] = 0.9
    cases = [
        ("random normal", rng.normal(scale=0.2, size=(2, h, w, 18)), 32),
        ("gaussian bumps", bumps((2, 24, 32, 3), 3, rng), 8),
        ("off-grid size 21x19", rng.normal(scale=0.2, size=(21, 19, 4)), 16),
        ("constant plateau", plateau, 4),
        ("row-piece plateau", piece, 16),
        ("batch dims", rng.normal(scale=0.2, size=(2, 2, 16, 26, 3)), 8),
        ("model heatmaps", main_heat, k_main),
        ("model heatmaps K=16 (the pipeline's)", main_heat, k_pipe),
        ("model heatmaps K=128", main_heat, 128),
        ("model heatmaps K=1", main_heat, 1),
        ("model heatmaps K=37", main_heat, 37),
        ("whole-plane plateau K=128", whole_plane, 128),
        # K above what the merge keeps in shared memory.
        ("whole-plane plateau K=4096", whole_plane, 4096),
        ("strided [..., :18] of 19 channels", strided, k_main),
        ("46x80 field K=512", rng.normal(scale=0.2, size=(2, 46, 80, 18)),
         512),
        ("model heatmaps K=0", main_heat, 0),
        # 33x33 = 1089 tiles: more tiles than the merge stages.
        ("132x264 field K=8", rng.normal(scale=0.2, size=(1, 132, 264, 1)),
         8),
    ]
    by_label = {label: heat_case for label, heat_case, _ in cases}
    max_abs_err = 0.0
    for label, heat_case, k in cases:
        t = torch.as_tensor(heat_case, dtype=torch.float32, device=dev)
        if heat_case is strided and (t.data_ptr() != heat19.data_ptr()
                                     or t.is_contiguous()):
            raise AssertionError("the strided case must pass the view")
        got = fp.find_peaks_fused(t, 0.1, k)
        expected = fp.find_peaks_fused_plain(t, 0.1, k)
        torch.cuda.synchronize()
        assert_same(got, expected, label)
        if got[1].numel():
            max_abs_err = max(max_abs_err,
                              float((got[1] - expected[1]).abs().max()))
        log(f"kernel == plain: {label} {tuple(t.shape)} K={k}: "
            f"{int(got[2].sum())} peaks kept, "
            f"{int(got[3].sum())} parts overflowed")

    # The merge kernel alone against its plain version, on the scan
    # kernel's own output.
    for label, heat_case, k in (("model heatmaps", strided, k_main),
                                ("model heatmaps", strided, 128),
                                ("whole-plane plateau", whole_plane, 128),
                                ("46x80 field", by_label["46x80 field K=512"],
                                 512),
                                ("132x264 field",
                                 by_label["132x264 field K=8"], 8)):
        t = torch.as_tensor(heat_case, dtype=torch.float32, device=dev)
        keys, counts = fp.scan_tiles(t, 0.1, k)
        got = fp.merge_tiles(keys, counts, t.shape[-2] * 8)
        expected = fp.merge_candidates(*fp.decode_tile_keys(keys, counts),
                                       counts, k, t.shape[-2] * 8)
        torch.cuda.synchronize()
        assert_same(got, expected, f"merge kernel, {label} K={k}")
        total = counts.sum(dim=1)
        if heat_case is whole_plane and int(total[0]) != PLATEAU_PEAKS:
            raise AssertionError(f"plateau: {int(total[0])} peaks, "
                                 f"expected {PLATEAU_PEAKS}")
        log(f"merge kernel == merge_candidates: {label} K={k}: "
            f"{int(total.max())} peaks in the busiest plane, "
            f"{int(counts.max())} in the busiest tile")

    # Times at K=16 (the pipeline's), K=32 (the pose task's) and K=128
    # on the pose path's own strided view.
    ms = {k: time_ms(lambda k=k: fp.find_peaks_fused(strided, 0.1, k))
          for k in (k_pipe, k_main, 128)}
    plain_ms = {k: time_ms(
        lambda k=k: fp.find_peaks_fused_plain(main_heat, 0.1, k))
        for k in (k_pipe, k_main)}
    bound = {k: kernel_bound_ms(n * parts, h, w, k) for k in (k_pipe, k_main)}
    bound_ms, bound_by = bound[k_main]
    log(f"timing at the main-path shape ({card}): find_peaks_fused "
        f"{ms[k_pipe]:.4f} ms at K={k_pipe}, {ms[k_main]:.4f} ms at "
        f"K={k_main}, {ms[128]:.4f} ms at K=128; plain version "
        f"{plain_ms[k_pipe]:.4f} / {plain_ms[k_main]:.4f} ms at K={k_pipe} / "
        f"{k_main}; bound {bound[k_pipe][0]:.5f} / {bound_ms:.5f} ms "
        f"({bound_by})")

    # Limb scores at the pipeline's K=16 on the model's PAFs and peaks:
    # the sampled form against the materialised one the pipeline runs.
    peak_coords, _, peak_valid, _ = fp.find_peaks_fused(strided, 0.1,
                                                         k_pipe)
    sampled = sampled_limbs_phase(paf.float(), peak_coords, peak_valid, card)

    # The NMS kernel against its plain version, on the detector's own
    # boxes among others.
    face_rng = np.random.default_rng(SEED + 1)
    raw["retinaface"] = random_retinaface_state_dict(face_rng)
    raw["arcface"] = random_arcface_state_dict(face_rng)
    rf_params = convert_retinaface(raw["retinaface"])
    arc_params = convert_arcface(raw["arcface"])
    detector = RetinaFaceDetector(params=rf_params)
    nms_fields, nms_err, model_boxes = nms_phase(detector, frames, face_rng,
                                                 dev, card)

    # 4. The main paths, bf16, through the task APIs.
    task = Estimation(params=state_dict)
    if task.model.model.compute_dtype != torch.bfloat16:
        raise AssertionError("the main path must run the default bf16 "
                             "policy (TERRAN_TPU_COMPUTE_DTYPE unset)")
    fp.find_peaks_fused.launches = 0
    warm_start = time.perf_counter()
    out = task(frames)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - warm_start
    times = []
    for _ in range(TIMED_CALLS):
        start = time.perf_counter()
        out = task(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    launches = fp.find_peaks_fused.launches
    if launches < 2:
        raise AssertionError("the main path did not launch the kernels")
    batch_ms = 1e3 * sorted(times)[len(times) // 2]
    escalations = task.model.escalation_count
    people = [len(p) for p in out]
    log(f"main path ({card}): batch {BATCH} x {FRAME[0]}x{FRAME[1]}, "
        f"short side {task.short_side}, bf16: warm call {warm_s:.3f} s, "
        f"{batch_ms:.2f} ms/batch median of {TIMED_CALLS} "
        f"({BATCH * 1e3 / batch_ms:.2f} frames/s); kernel launches "
        f"{launches}; escalations {escalations} over "
        f"{1 + TIMED_CALLS} calls; people per frame {people}")
    assert len(out) == BATCH
    for frame_people in out:
        for person in frame_people:
            kp = person["keypoints"]
            assert kp.shape == (18, 3) and kp.dtype == np.int32
            present = kp[kp[:, 2] == 1]
            assert (present[:, 0] >= 0).all() and (present[:, 1] >= 0).all()
            assert (present[:, 0] <= FRAME[1]).all()
            assert (present[:, 1] <= FRAME[0]).all()
            assert np.isfinite(person["score"])

    small = Estimation(params=state_dict, max_peaks=4)
    small(frames[:2])
    if small.model.escalation_count < 1:
        raise AssertionError("max_peaks=4 did not escalate")
    log(f"max_peaks=4: {small.model.escalation_count} escalation(s)")

    nms_calls, det_ms = detection_phase(rf_params, frames, card)
    rec_ms = recognition_phase(arc_params, frames, face_rng, card)
    # The int8 trunks: every quantised conv shape against its plain
    # version, then both task APIs with 'int8'.
    int8_convs, int8_cases = int8_conv_phase(arc_params, state_dict, dev,
                                             card)
    int8_tasks = int8_task_phase(arc_params, state_dict, frames, face_rng,
                                 card, {"pose": batch_ms,
                                        "recognition": rec_ms})

    # This slice's main path: the store filled by the CLI, then the
    # default-constructed entry points from it, the streams example, the
    # leaf group where its libraries import, and delete.
    pipe_params = (rf_params, arc_params, state_dict)
    batches = pipeline_batches()
    store = store_phase(raw, pipe_params, frames, batches[0],
                        np.random.default_rng(SEED + 3), card)

    # The perception pipeline: detect + embed + pose over batches, both
    # kernels on every batch.
    pipe, warm_pipe = pipeline_phase(pipe_params, batches, card, {
        "pose": batch_ms, "detection": det_ms, "recognition": rec_ms})
    # This slice's main path: the same pipeline with both int8 trunks,
    # right after the native one.
    # The pipeline's CUDA graphs against its eager launches.
    graphs = graphs_phase(pipe_params, card)
    # The conv epilogue kernel on an eager batch: one launch a conv and
    # standalone affine, and its time against its byte bound.
    epilogue = conv_epilogue_phase(pipe_params, batches, card)
    pipe_int8 = pipeline_int8_phase(pipe_params, batches, card, pipe)
    # BODY_25 on the pose path: its pipeline, eager then replayed, and the
    # peak kernel on its 25-part view.
    body25_run, body25_pipe = body25_phase(rf_params, batches, card)
    # This slice's main path: concurrent streams with tracking through
    # the warm pipeline.
    streams = streams_phase(warm_pipe, card)
    # The same path under the 'host' transfer plan as bench.py runs it,
    # and with the exact chain (the numpy warp) whatever is installed;
    # then host assembly.
    pipe_host = pipeline_host_phase(pipe_params, batches, card, pipe)
    pipe_exact = pipeline_host_phase(pipe_params, batches, card, pipe,
                                     host_resize="exact")
    # This slice's main path: the pipeline under a world-1 NCCL mesh,
    # the sharded NMS and the spatially sharded detector on the card.
    scaleout = scaleout_phase(pipe_params, rf_params, batches, model_boxes,
                              dev, card)
    traced_batches = batches[:TRACED_BATCHES]
    assembly = assembly_phase(card)
    tiled = tiled_phase(rf_params, dev, card)
    no_landmarks = recognition_no_landmarks_phase(arc_params, dev, card)

    # 5. float32, TF32 off: fused vs materialised, card vs CPU.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    fused = OpenPoseEstimator(params=state_dict,
                              compute_dtype=torch.float32,
                              use_fused_peaks=True)
    plain = OpenPoseEstimator(params=state_dict,
                              compute_dtype=torch.float32,
                              use_fused_peaks=False)
    (arrays_fused, _), (arrays_plain, _) = (
        fused.decode(frames), plain.decode(frames)
    )
    c_f, s_f, v_f, reg_f, acc_f, o_f = arrays_fused
    c_p, s_p, v_p, reg_p, acc_p, o_p = arrays_plain
    for name, a, b in (("valid", v_f, v_p), ("overflow", o_f, o_p),
                       ("scores", s_f, s_p), ("accept", acc_f, acc_p),
                       ("coords", c_f[v_f], c_p[v_p])):
        np.testing.assert_array_equal(a, b, err_msg=f"float32 {name}")
    out_fused, out_plain = fused.call(frames), plain.call(frames)
    for a_frame, b_frame in zip(out_fused, out_plain):
        assert len(a_frame) == len(b_frame)
        for a, b in zip(a_frame, b_frame):
            np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
            assert a["score"] == b["score"]
    log(f"float32: fused and materialised decode arrays and keypoints "
        f"equal ({int(v_f.sum())} peaks, {int(acc_f.sum())} accepted limb "
        f"pairs, {sum(len(p) for p in out_fused)} people)")

    cpu = OpenPoseEstimator(params=state_dict, device="cpu",
                            compute_dtype=torch.float32)
    x = torch.as_tensor(rng.uniform(-0.5, 0.5, (1, 96, 128, 3)),
                        dtype=torch.float32)
    with torch.inference_mode():
        ref = cpu.model(x)
        got = fused.model(x.to(dev))
    for name, g, r in zip(("pafs", "heatmaps"), got, ref):
        err = float((g.cpu() - r).abs().max())
        if not err <= 2e-4:
            raise AssertionError(f"card vs CPU forward: {name} max abs "
                                 f"error {err}")
        log(f"card vs CPU float32 forward: {name} max abs error {err:.2e}")

    face_float32_phase(rf_params, arc_params, face_rng, dev)
    int8_f32 = int8_float32_phase(arc_params, state_dict, dev, card)
    pipeline_float32_phase(pipe_params, face_rng, dev, card)
    host_f32 = pipeline_host_float32_phase(pipe_params, face_rng, dev, card)

    # 6. The profiler, last: it stays attached to the process and slows
    #    later launches. One call's CUDA kernels, then the kernels' device
    #    time a call at K=32 and K=128.
    kernels_per_call, _, names = profile_call(
        lambda: fp.find_peaks_fused(strided, 0.1, k_main), 1)
    log(f"CUDA kernels in one find_peaks_fused call: {kernels_per_call:g} "
        f"({', '.join(sorted(names))})")
    if not 1 <= kernels_per_call <= 2:
        raise AssertionError(f"{kernels_per_call} CUDA kernels in one call, "
                             "expected the scan and the merge")
    kernel_ms = {}
    for k in (k_pipe, k_main, 128):
        _, kernel_ms[k], names = profile_call(
            lambda k=k: fp.find_peaks_fused(strided, 0.1, k), 20)
        log(f"kernels at K={k} ({card}): {kernel_ms[k]:.4f} ms a call ("
            + ", ".join(f"{name} {t:.4f} ms"
                        for name, t in sorted(names.items()))
            + ")")

    # Suppression calls at N=8, K=256 and 1024 on the model's pre-selected
    # boxes: two kernels a call, each timed.
    nms_kernel_ms = {}
    for k in (PIPE_CONFIG["top_k"], 256, 1024):
        top = nms.nms_fixed(*model_boxes, 0.4, score_threshold=0.5, top_k=k)
        valid = torch.isfinite(top[1])
        records, calls = {}, 20
        _, total, names = profile_call(
            lambda: nms.suppress(top[0], valid, 0.4), calls, records)
        # Kernels a call, counted by name: each kernel's records over the
        # calls, rounded, so that a record the profiler loses (it once
        # reported 39 of 40) is logged and does not change the count.
        nms_kernels = sum(round(n / calls) for n in records.values())
        lost = 2 * calls - sum(records.values())
        log(f"CUDA kernels in one NMS suppress call at N=8, K={k}: "
            f"{nms_kernels:g} ({records} records over {calls} calls, "
            f"{lost} lost by the profiler); device time {total:.4f} ms a "
            "call ("
            + ", ".join(f"{name} {t:.4f} ms"
                        for name, t in sorted(names.items()))
            + f") ({card})")
        if (nms_kernels != 2
                or set(records) != {"mask_kernel", "sweep_kernel"}
                or any(round(n / calls) != 1 for n in records.values())):
            raise AssertionError(f"{nms_kernels} CUDA kernels in one "
                                 f"suppress call ({records} records over "
                                 f"{calls} calls), expected mask_kernel and "
                                 "sweep_kernel once each")
        nms_kernel_ms[k] = dict(names, total=total)

    # The int8 convs: device records and ms a call, kernels beside eager.
    int8_launches = int8_conv_launches(int8_cases, card)
    del int8_cases

    # Both kernels on every batch of the warm pipeline's stream and of the
    # concurrent streams, from the profiler's kernel records of one sweep
    # each like the timed ones (the kernels' Python counters see no
    # replayed graph), every program call a replay.
    from terran_tpu_torch.io.streams import MultiStreamPerception

    for what, fields, swept, sweep in (
            ("the pipeline", pipe, warm_pipe,
             lambda: list(warm_pipe.process_stream(batches,
                                                   depth=PIPE_DEPTH))),
            ("streams", streams, warm_pipe, lambda: list(
                MultiStreamPerception(warm_pipe, stream_sources(),
                                      batch_size=BATCH, track=True))),
            ("the BODY_25 pipeline", body25_run, body25_pipe,
             lambda: list(body25_pipe.process_stream(batches,
                                                     depth=PIPE_DEPTH)))):
        calls, since = dict(swept.graph_calls), dispatched(swept)
        fields["launches"] = kernel_launches(sweep)
        # kernel_launches runs the sweep three times, one under the record.
        check_replayed(swept, calls, 3 * fields["batches"], since, what)
        check_launches(fields["launches"], fields["batches"], what)
    log(f"kernel launches per batch, profiler records of one sweep "
        f"({card}): pipeline "
        + ", ".join(f"{k} {v / pipe['batches']:g}"
                    for k, v in pipe["launches"].items())
        + "; streams "
        + ", ".join(f"{k} {v / streams['batches']:g}"
                    for k, v in streams["launches"].items())
        + "; BODY_25 "
        + ", ".join(f"{k} {v / body25_run['batches']:g}"
                    for k, v in body25_run["launches"].items()))
    del warm_pipe, body25_pipe, batches

    # The package's runtime and tracing names, last: a trace of the warm
    # pipeline through start_trace/stop_trace.
    observability = observability_phase(pipe_params, traced_batches, card)
    del traced_batches

    # 7. Results.
    log(json.dumps({"pipeline": {
        "frames_per_s": pipe["fps_median"], "frames_per_s_sweeps": pipe["fps"],
        "ms_per_batch": pipe["batch_ms"], "task_api_ms": pipe["task_ms"],
        "launches_per_batch": {name: count / pipe["batches"] for name, count
                               in pipe["launches"].items()},
        "warmup_programs": pipe["warmup_programs"],
        "graph_calls": pipe["graph_calls"],
        "escalations": pipe["escalations"], "card": card,
    }}))
    log(json.dumps({"pipeline_host": {
        "frames_per_s": pipe_host["fps_median"],
        "frames_per_s_sweeps": pipe_host["fps"],
        "ms_per_batch": pipe_host["batch_ms"],
        "device_plan_frames_per_s": pipe["fps_median"],
        "device_plan_frames_per_s_sweeps": pipe["fps"],
        "upload_bytes_per_frame": {
            "host": pipe_host["upload_bytes_per_frame"],
            "device": pipe["upload_bytes_per_frame"]},
        "stage_ms_per_batch": pipe_host["stages_ms_per_batch"],
        "bench_rule_picks": pipe_host["picks"],
        "host_resize": pipe_host["host_resize"],
        "exact_chain": {key: pipe_exact[key] for key in (
            "fps", "fps_median", "batch_ms", "stages_ms_per_batch",
            "upload_bytes_per_frame", "picks")},
        "launches_per_batch": {name: count / pipe_host["batches"] for
                               name, count in pipe_host["launches"].items()},
        "warmup_programs": pipe_host["warmup_programs"],
        "float32_vs_device_plan": host_f32,
        "assembly_ms_per_batch": assembly,
        "native_build_s": native_s,
        "limb_scores": sampled,
        "card": card,
    }}))
    log(json.dumps({"streams": {
        "frames_per_s": streams["fps_median"],
        "frames_per_s_sweeps": streams["fps"],
        "plain_process_stream_frames_per_s": streams["plain_fps_median"],
        "plain_process_stream_frames_per_s_sweeps": streams["plain_fps"],
        "ratio_to_plain": streams["ratio"],
        "tracking_host_ms_per_batch": streams["track_ms_per_batch"],
        "launches_per_batch": {name: count / streams["batches"] for
                               name, count in streams["launches"].items()},
        "confirmed_tracks_per_stream": streams["confirmed_tracks"],
        "tracked_faces_per_frame": streams["tracked_faces_per_frame"],
        "detected_faces_per_frame": streams["detected_faces_per_frame"],
        "embedding_err_vs_process_batch": streams["embedding_err_vs_batch"],
        "environment": env,
        "card": card,
    }}))
    log(json.dumps({"int8": {
        "pipeline": {key: pipe_int8[key] for key in (
            "fps_median", "fps", "batch_ms", "native_fps_median",
            "native_fps", "ratio_to_native", "launches_per_batch",
            "warmup_programs")},
        "task_apis": int8_tasks, "float32_models": int8_f32,
        "device_product": "torch._int_mm (library call, not a kernel of "
                          "the repository) between csrc/quant_conv.cu's "
                          "quantisation and epilogue kernels",
        "card": card,
    }}))
    log(json.dumps({"graphs": dict(graphs, card=card)}))
    log(json.dumps({"body25": dict(body25_run, card=card)}))
    log(json.dumps({"int8_convs": int8_convs}))
    log(json.dumps({"int8_conv_launches": int8_launches}))
    log(json.dumps({"tiled": dict(tiled, card=card)}))
    log(json.dumps({"scaleout": dict(scaleout, card=card)}))
    log(json.dumps({"recognition_no_landmarks": dict(no_landmarks,
                                                     card=card)}))
    log(json.dumps({"store": dict(store, environment=env, card=card)}))
    log(json.dumps({"observability": dict(observability, card=card)}))
    log(json.dumps({"kernels": [{
        "name": "fused_peaks",
        "route": "cuda",
        "source": "terran_tpu_torch/csrc/fused_peaks.cu",
        "replaces": "terran_tpu/ops/fused_peaks.py:71",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "exact": max_abs_err == 0.0,
        "ms": ms[k_main],
        "kernel_ms": kernel_ms[k_main],
        "ms_k128": ms[128],
        "kernel_ms_k128": kernel_ms[128],
        "kernels_per_call": kernels_per_call,
        "plain_ms": plain_ms[k_main],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "ms_k16": ms[k_pipe],
        "kernel_ms_k16": kernel_ms[k_pipe],
        "plain_ms_k16": plain_ms[k_pipe],
        "bound_ms_k16": bound[k_pipe][0],
        "bound_by_k16": bound[k_pipe][1],
        "pipeline_launches": pipe["launches"]["fused_peaks"],
        "pipeline_batches": pipe["batches"],
        "pipeline_launches_per_batch":
            pipe["launches"]["fused_peaks"] / pipe["batches"],
        "pipeline_int8_launches_per_batch":
            pipe_int8["launches_per_batch"]["fused_peaks"],
        "pipeline_host_launches": pipe_host["launches"]["fused_peaks"],
        "pipeline_host_launches_per_batch":
            pipe_host["launches"]["fused_peaks"] / pipe_host["batches"],
        "streams_launches": streams["launches"]["fused_peaks"],
        "streams_launches_per_batch":
            streams["launches"]["fused_peaks"] / streams["batches"],
        "tiled_launches_per_call": tiled["peak_launches"][-1],
        "scaleout_launches": scaleout["launches"]["fused_peaks"],
        "scaleout_launches_per_batch":
            scaleout["launches_per_batch"]["fused_peaks"],
        "store_launches": store["store_launches"]["fused_peaks"],
        "traced_launches": observability["launches"]["fused_peaks"],
        "traced_batches": observability["traced_batches"],
        "library_ms": None,
        "card": card,
    }, {
        "name": "nms",
        "route": "cuda",
        "source": "terran_tpu_torch/csrc/nms.cu",
        "replaces": "terran_tpu/ops/nms.py:82",
        "launches": 2 * nms_calls,
        "calls": nms_calls,
        "max_abs_err": nms_err,
        "exact": nms_err == 0.0,
        "ms": nms_fields[256]["ms"],
        "kernel_ms": nms_kernel_ms[256]["total"],
        "mask_kernel_ms": nms_kernel_ms[256]["mask_kernel"],
        "sweep_kernel_ms": nms_kernel_ms[256]["sweep_kernel"],
        "ms_k1024": nms_fields[1024]["ms"],
        "kernel_ms_k1024": nms_kernel_ms[1024]["total"],
        "mask_kernel_ms_k1024": nms_kernel_ms[1024]["mask_kernel"],
        "sweep_kernel_ms_k1024": nms_kernel_ms[1024]["sweep_kernel"],
        "nms_fixed_ms": nms_fields[256]["call_ms"],
        "kernels_per_call": nms_kernels,
        "plain_ms": nms_fields[256]["plain_ms"],
        "plain_ms_k1024": nms_fields[1024]["plain_ms"],
        "bound_ms": nms_fields[256]["bound_ms"],
        "bound_ms_k1024": nms_fields[1024]["bound_ms"],
        "bound_by": nms_fields[256]["bound_by"],
        "chain_steps": nms_fields[256]["chain_steps"],
        "chain_steps_k1024": nms_fields[1024]["chain_steps"],
        "ms_k64": nms_fields[64]["ms"],
        "kernel_ms_k64": nms_kernel_ms[64]["total"],
        "nms_fixed_ms_k64": nms_fields[64]["call_ms"],
        "plain_ms_k64": nms_fields[64]["plain_ms"],
        "bound_ms_k64": nms_fields[64]["bound_ms"],
        "bound_by_k64": nms_fields[64]["bound_by"],
        "chain_steps_k64": nms_fields[64]["chain_steps"],
        "pipeline_launches": pipe["launches"]["nms"],
        "pipeline_batches": pipe["batches"],
        "pipeline_launches_per_batch":
            pipe["launches"]["nms"] / pipe["batches"],
        "pipeline_int8_launches_per_batch":
            pipe_int8["launches_per_batch"]["nms"],
        "pipeline_host_launches": pipe_host["launches"]["nms"],
        "pipeline_host_launches_per_batch":
            pipe_host["launches"]["nms"] / pipe_host["batches"],
        "streams_launches": streams["launches"]["nms"],
        "streams_launches_per_batch":
            streams["launches"]["nms"] / streams["batches"],
        "tiled_launches_per_call": 2 * tiled["nms_calls"][-1],
        "scaleout_launches": scaleout["launches"]["nms"],
        "scaleout_launches_per_batch":
            scaleout["launches_per_batch"]["nms"],
        "scaleout_sharded_nms_launches": 2 * scaleout["sharded_nms_calls"],
        "scaleout_spatial_launches": 2 * scaleout["spatial_nms_calls"],
        "scaleout_spatial_calls": scaleout["spatial_calls"],
        "scaleout_spatial_launches_per_call":
            2 * scaleout["spatial_nms_calls"] / scaleout["spatial_calls"],
        "scaleout_4_slab_replay_launches":
            2 * scaleout["replay_4_slab_nms_calls"],
        "store_launches": store["store_launches"]["nms"],
        "traced_launches": observability["launches"]["nms"],
        "traced_batches": observability["traced_batches"],
        "library_ms": None,
        "card": card,
    }, int8_kernels_entry(int8_convs, int8_launches, pipe_int8, card), {
        "name": "conv_epilogue",
        "route": "cuda",
        "source": "terran_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": None,
        "pipeline": epilogue,
        "body25": body25_run["conv_epilogue"],
        "library_ms": None,
        "card": card,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
