#!/usr/bin/env python3
"""Where the main paths' time goes on one NVIDIA card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_profile.py

Same configurations as ``chip_smoke.py``'s main paths (8 seeded 1080p
frames, random reference-format weights, bf16): pose at short side 184
with full OpenPose, detection at short side 416 with full RetinaFace, and
recognition of 8 faces a frame with full FaceResNet100. Prints:

1. per-stage device times of one pose decode at each K the path escalates
   through (CUDA events around each stage, with a synchronise between
   stages so each is attributed on its own), plus the host's share
   (copy back and assembly);
2. the same stage times for one detection step at each K the path
   escalates through (upload, resize, forward, decode, pre-selection,
   suppression, copy back), and the forward's depthwise convolutions
   apart;
3. stage times of the recognition of one frame's faces (upload,
   alignment solve on the host, warp, forward, copy back);
4. ``torch.profiler`` traces, last (the profiler slows later launches in
   its process), of one full task-API call of each path: the ten kernels
   with the most device time, the device's busy share of the call's wall
   time, and the hand-written kernels' launches and device time (pose:
   the fused peak-scan kernels, ``csrc/fused_peaks.cu``, scan and merge,
   two launches per decode; detection: ``csrc/nms.cu``, mask and sweep,
   two launches per decode);
5. the perception pipeline at ``chip_smoke.py``'s configuration
   (bench.py's: top_k 64, max_faces 8, max_peaks 16, depth 2): the
   ``StageTimer`` host times of one ``process_stream`` sweep over 8
   batches, before any profiler; then, last, under ``torch.profiler``,
   the device's busy share of one sweep and, for one ``process_batch``,
   its kernel launches, the ten kernels with the most device time and the
   hand-written kernels' launches and device time.
"""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
BATCH = 8
FRAME = (1080, 1920)
REPEATS = 5


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import card_line
    from terran_tpu_torch.utils.convert import (
        convert_arcface, convert_retinaface,
    )
    from torch_oracle import (
        random_arcface_state_dict, random_retinaface_state_dict,
    )
    from terran_tpu_torch.ops.fused_peaks import find_peaks_fused
    from terran_tpu_torch.ops.pose_decode import (
        limb_scores, normalize_images, pack_peaks, unpack_pose_outputs,
    )
    from terran_tpu_torch.ops.upsample import upsample_bicubic
    from terran_tpu_torch.pose.assembly import assemble_humans
    from terran_tpu_torch.pose.openpose import OpenPoseEstimator
    from terran_tpu_torch.utils.convert import convert_openpose
    from torch_oracle import random_openpose_state_dict

    card = card_line()
    print(f"card: {card}", flush=True)
    rng = np.random.default_rng(SEED)
    state_dict = convert_openpose(random_openpose_state_dict(rng))
    frames = rng.integers(0, 256, (BATCH,) + FRAME + (3,), dtype=np.uint8)
    est = OpenPoseEstimator(params=state_dict)
    est.call(frames)  # builds the kernel, warms cuDNN

    def stages(k):
        """Stage name -> ms for one decode at K=k."""
        out = {}
        ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

        def timed(name, fn):
            torch.cuda.synchronize()
            start, end = ev(), ev()
            start.record()
            result = fn()
            end.record()
            torch.cuda.synchronize()
            out[name] = start.elapsed_time(end)
            return result

        with torch.inference_mode():
            up = timed("upload (pageable h2d)",
                       lambda: torch.from_numpy(frames).to(est.device))
            resized = timed("resize", lambda: est._resize_in(up)[0])
            paf, heat = timed("forward (bf16)", lambda: est.model(
                normalize_images(resized).to(est.model.compute_dtype)))
            heat = heat.float()[..., :18]
            peaks = timed(f"fused peaks K={k}",
                          lambda: find_peaks_fused(heat, 0.1, k))
            paf_up = timed("paf x8 upsample",
                           lambda: upsample_bicubic(paf.float(), 8))
            reg, accept = timed(f"limb scores K={k}", lambda: limb_scores(
                paf_up, peaks[0], peaks[2], 0.05))
            packed = timed("pack + copy to host", lambda: (
                pack_peaks(*peaks).cpu().numpy(),
                torch.stack([reg, accept.float()], -1).cpu().numpy()))
        arrays = unpack_pose_outputs(*packed)
        start = time.perf_counter()
        for i in range(BATCH):
            assemble_humans(*(a[i] for a in arrays[:5]))
        out["host assembly (host clock)"] = 1e3 * (
            time.perf_counter() - start)
        return out

    ks = [est.max_peaks * 2 ** i for i in range(est.max_escalations + 1)]
    for k in ks:
        runs = [stages(k) for _ in range(REPEATS)]
        print(f"stages at K={k} ({card}), median of {REPEATS}:", flush=True)
        total = 0.0
        for name in runs[0]:
            ms = sorted(r[name] for r in runs)[REPEATS // 2]
            total += ms
            print(f"  {name:32s} {ms:9.3f} ms")
        print(f"  {'sum':32s} {total:9.3f} ms", flush=True)

    # The face paths' stages before any profiler: it stays attached to
    # the process and slows later launches.
    face_rng = np.random.default_rng(SEED + 1)
    rf_params = convert_retinaface(random_retinaface_state_dict(face_rng))
    arc_params = convert_arcface(random_arcface_state_dict(face_rng))
    detection = detection_stages(rf_params, frames, card)
    recognition, faces = recognition_stages(arc_params, frames, face_rng,
                                            card)
    pipe, batches = pipeline_stages((rf_params, arc_params, state_dict),
                                    card)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        est.call(frames)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled call ({card}): wall {wall_ms:.2f} ms, device busy "
          f"{device_us / 1e3:.2f} ms ({100 * device_us / 1e3 / wall_ms:.1f}%"
          f" of wall), escalations so far {est.escalation_count}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    peaks = [e for e in kernels
             if "::scan_kernel(" in e.key or "::merge_kernel(" in e.key]
    print(f"fused peaks kernels in the profiled call ({card}): "
          f"{sum(e.count for e in peaks)} launches, "
          f"{sum(e.self_device_time_total for e in peaks) / 1e3:.4f} ms "
          "device time")

    profiled(lambda: detection(frames), card, "detection task call",
             ("::mask_kernel(", "::sweep_kernel("))
    profiled(lambda: recognition(list(frames), faces), card,
             "recognition task call", ())
    profiled(lambda: sweep(pipe, batches), card,
             f"pipeline sweep of {len(batches)} batches", ())
    profiled(lambda: pipe.process_batch(batches[0]), card,
             "pipeline process_batch",
             ("::scan_kernel(", "::merge_kernel(", "::mask_kernel(",
              "::sweep_kernel("))
    return 0


def sweep(pipe, batches):
    from chip_smoke import PIPE_DEPTH

    for _ in pipe.process_stream(batches, depth=PIPE_DEPTH):
        pass


def pipeline_stages(params, card):
    """The pipeline at chip_smoke.py's configuration, warmed, then the
    StageTimer's host times of one sweep. Returns (pipeline, batches)."""
    import numpy as np

    from chip_smoke import BATCH, PIPE_BATCHES, PIPE_DEPTH, pipeline_kwargs
    from terran_tpu_torch.pipeline import PerceptionPipeline
    from terran_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    pipe = PerceptionPipeline(**pipeline_kwargs(params, timer=timer))
    rng = np.random.default_rng(SEED + 2)
    batches = [rng.integers(0, 255, (BATCH,) + FRAME + (3,), dtype=np.uint8)
               for _ in range(PIPE_BATCHES)]
    pipe.warmup(BATCH, *FRAME)
    pipe.process_batch(batches[0])
    sweep(pipe, batches[:2])
    timer.reset()
    start = time.perf_counter()
    sweep(pipe, batches)
    wall_ms = 1e3 * (time.perf_counter() - start)
    print(f"pipeline sweep ({card}): {PIPE_BATCHES} batches x {BATCH} x "
          f"{FRAME[0]}x{FRAME[1]}, depth {PIPE_DEPTH}: wall {wall_ms:.2f} ms "
          f"({wall_ms / PIPE_BATCHES:.2f} ms/batch); StageTimer, host wall "
          "time (a dispatch span is the enqueue, not the device time):",
          flush=True)
    for name, total in timer.times.items():
        calls = timer.counts[name]
        print(f"  {name:20s} {1e3 * total / calls:9.4f} ms mean x {calls} "
              f"= {1e3 * total:9.4f} ms")
    pipe.timer = None
    return pipe, batches


def timer():
    """(stage times dict, timed(name, fn)): CUDA events around ``fn``,
    synchronised before and after so each stage stands on its own."""
    import torch

    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end)
        return result

    return out, timed


def print_medians(title, runs):
    print(f"{title}, median of {len(runs)}:", flush=True)
    total = 0.0
    for name in runs[0]:
        ms = sorted(r[name] for r in runs)[len(runs) // 2]
        total += ms
        print(f"  {name:36s} {ms:9.3f} ms")
    print(f"  {'sum':36s} {total:9.3f} ms", flush=True)


def depthwise_ms(model, x):
    """Device ms of the forward's depthwise convolutions (groups > 1),
    each timed by CUDA events in hooks, and of the whole forward."""
    import torch

    convs = [m for m in model.modules()
             if isinstance(m, torch.nn.Conv2d) and m.groups > 1]
    events = []

    def pre(module, args):
        events.append([torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)])
        events[-1][0].record()

    def post(module, args, output):
        events[-1][1].record()

    hooks = [h for m in convs for h in (m.register_forward_pre_hook(pre),
                                        m.register_forward_hook(post))]
    try:
        out, timed = timer()
        timed("forward", lambda: model(x))
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events), out["forward"], len(
        convs)


def profiled(fn, card, title, match):
    """One call of ``fn`` under torch.profiler: wall, busy share, the ten
    kernels with the most device time, and the kernels whose name
    contains one of the strings ``match``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - start)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    print(f"profiled {title} ({card}): wall {wall_ms:.2f} ms, device busy "
          f"{device_us / 1e3:.2f} ms ({100 * device_us / 1e3 / wall_ms:.1f}%"
          f" of wall), {sum(e.count for e in kernels)} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    if match:
        hits = [e for e in kernels if any(m in e.key for m in match)]
        print(f"  {' + '.join(match)}: {sum(e.count for e in hits)} "
              f"launches, "
              f"{sum(e.self_device_time_total for e in hits) / 1e3:.4f} ms "
              "device time", flush=True)
        for e in hits:
            print(f"    {e.count:3d}x {e.self_device_time_total / 1e3:.4f} "
                  f"ms  {e.key[:60]}", flush=True)


def detection_stages(rf_params, frames, card):
    import torch

    from chip_smoke import DETECT_SHAPE
    from terran_tpu_torch.face import Detection
    from terran_tpu_torch.models.retinaface import (
        anchor_cell_meta, anchors_for_shape, decode_outputs,
    )
    from terran_tpu_torch.ops import nms

    task = Detection(params=rf_params)
    task(frames)  # warms cuDNN and builds the kernel
    det = task.model
    h, w = DETECT_SHAPE
    dev = det.device
    anchors = torch.from_numpy(anchors_for_shape(h, w)).to(dev)
    cell_x, cell_y, cell_stride = (torch.from_numpy(a).to(dev)
                                   for a in anchor_cell_meta(h, w))

    def stages(k):
        out, timed = timer()
        with torch.inference_mode():
            up = timed("upload (pageable h2d)",
                       lambda: torch.from_numpy(frames).to(dev))
            resized = timed("resize", lambda: task.resize_in(up)[0])
            heads = timed("forward (bf16)", lambda: det.model(
                resized.to(det.model.compute_dtype)))
            scores, boxes, lmks = timed("decode + valid cells", lambda: (
                lambda s, b, l: (torch.where(
                    (cell_x < (w + cell_stride - 1) // cell_stride)
                    & (cell_y < (h + cell_stride - 1) // cell_stride),
                    s, 0.0), b, l))(*decode_outputs(heads, anchors)))

            def select():
                above = scores >= det.threshold
                masked = torch.where(above, scores, float("-inf"))
                top, order = torch.sort(masked, dim=1, descending=True,
                                        stable=True)
                top, order = top[:, :k], order[:, :k]
                return (boxes.gather(1, order[..., None].expand(-1, k, 4)),
                        top, order)

            top_boxes, top, order = timed(f"pre-selection K={k}", select)
            valid = torch.isfinite(top)
            keep = timed(f"suppression kernel K={k}", lambda: nms.suppress(
                top_boxes, valid, det.nms_threshold))
            timed("pack + copy to host", lambda: torch.cat([
                top_boxes, lmks.reshape(len(frames), -1, 10).gather(
                    1, order[..., None].expand(-1, k, 10)),
                top[..., None], keep[..., None].float()], -1).cpu().numpy())
        return out

    for k in [det.top_k * 2 ** i for i in range(det.max_escalations + 1)]:
        print_medians(f"detection stages at K={k} ({card})",
                      [stages(k) for _ in range(REPEATS)])
    x = task.resize_in(torch.from_numpy(frames).to(dev))[0].to(
        det.model.compute_dtype)
    with torch.inference_mode():
        runs = [depthwise_ms(det.model, x) for _ in range(REPEATS)]
    dw, fwd, count = sorted(runs)[REPEATS // 2]
    print(f"RetinaFace forward (bf16, {card}): {count} depthwise convs "
          f"{dw:.3f} ms of {fwd:.3f} ms (each timed in hooks, which adds "
          "event records to the forward)", flush=True)
    return task


def recognition_stages(arc_params, frames, rng, card):
    import torch

    from chip_smoke import synthetic_faces
    from terran_tpu_torch.face import Recognition
    from terran_tpu_torch.models.arcface import normalize_embeddings

    task = Recognition(params=arc_params)
    faces = synthetic_faces(rng, len(frames))
    task(list(frames), faces)  # warms cuDNN
    rec = task.model

    def stages():
        out, timed = timer()
        with torch.inference_mode():
            image = timed("upload one frame (pageable h2d)",
                          lambda: torch.from_numpy(frames[0]).to(rec.device))
            start = time.perf_counter()
            mats = rec._alignment_mats(faces[0])
            out["alignment solve (host clock)"] = 1e3 * (
                time.perf_counter() - start)
            crops = timed("warp + round", lambda: rec._warp(image, mats))
            feats = timed("forward (bf16) + normalise",
                          lambda: normalize_embeddings(rec.model(crops)))
            timed("copy to host", lambda: feats.cpu().numpy())
        return out

    print_medians(f"recognition stages for one frame's {len(faces[0])} "
                  f"faces ({card})", [stages() for _ in range(REPEATS)])
    return task, faces


if __name__ == "__main__":
    sys.exit(main())
