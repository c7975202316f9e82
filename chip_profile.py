#!/usr/bin/env python3
"""Where the pose main path's time goes on one NVIDIA card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_profile.py

Same configuration as ``chip_smoke.py``'s main path (8 seeded 1080p
frames, short side 184, full OpenPose with random reference-format
weights, bf16). Prints:

1. per-stage device times of one decode at each K the path escalates
   through (CUDA events around each stage, with a synchronise between
   stages so each is attributed on its own), plus the host's share
   (copy back and assembly);
2. a ``torch.profiler`` trace of one full task-API call: the ten kernels
   with the most device time, the device's busy share of the call's wall
   time, and the fused peak-scan kernels (``csrc/fused_peaks.cu``: scan
   and merge, two launches per decode) with their launches and device
   time.
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
