#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises, exits nonzero and prints no result line):

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the hand-written kernels (terran_tpu_torch/csrc/fused_peaks.cu:
   the tile scan and the plane merge) with nvcc;
3. hold the kernels against their plain PyTorch version on the card, exact
   equality of coords, valid, overflow and scores, on random fields,
   off-grid gaussian bumps, a height and width off the kernel's tile grid,
   exact-tie plateaus (one of them a whole 23x40 plane, every interior
   pixel a peak, at K=128 and K=4096), batch dims, the model's own
   heatmaps at the main path's shape at K = 0, 1, 32, 37 and 128, the
   strided [..., :18] view of the model's 19 channels, a 46x80 field
   (short side 368) at K=512 and a 132x264 field of 1089 tiles; hold the
   merge kernel alone against ``merge_candidates`` on the scan kernel's
   output; time the call with CUDA events at K=32 and K=128;
4. the main path: the pose task API (``Estimation``) on 8 seeded 1080p
   frames at the default short side 184, full OpenPose with random
   reference-format weights, bf16; the kernels' launch count must rise;
   then ``max_peaks=4`` must escalate;
5. float32 with TF32 off: the fused path and the materialised path
   (``fused_peaks='off'``) give equal keypoints, and the card's forward
   agrees with the CPU's on a small input;
6. ``torch.profiler``: the CUDA kernels of one call (at most 2), and the
   kernels' device time at K=32 and K=128;
7. a JSON line describing the kernels, then the result line.

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


def profile_call(fn, calls):
    """(CUDA kernels per call, device ms per call, {kernel name: device ms
    per call}) of ``calls`` calls of ``fn`` under torch.profiler; every
    device activity counts as a kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    # "(anonymous namespace)::scan_kernel(float const*, ...)" -> scan_kernel
    by_name = {}
    for e in events:
        name = re.search(r"(\w+)\(", e.key)
        name = name.group(1) if name else e.key
        by_name[name] = (by_name.get(name, 0.0)
                         + e.self_device_time_total / 1e3 / calls)
    return (sum(e.count for e in events) / calls, sum(by_name.values()),
            by_name)


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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    import numpy as np

    from terran_tpu_torch.ops import fused_peaks as fp
    from terran_tpu_torch.pose import Estimation
    from terran_tpu_torch.pose.openpose import OpenPoseEstimator
    from terran_tpu_torch.utils import cuda_build
    from terran_tpu_torch.utils.convert import convert_openpose
    from torch_oracle import random_openpose_state_dict

    dev = torch.device(DEVICE)
    # The checkpoint registry's home lives in the checkout's build dir.
    os.environ["TERRAN_TPU_HOME"] = str(REPO / "build" / "terran-home")

    # 1. The card.
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # 2. Build.
    start = time.perf_counter()
    fp._library()
    log(f"build: fused_peaks.cu (scan + merge kernels) in {time.perf_counter() - start:.2f} s "
        f"(nvcc {cuda_build.build_seconds.get('fused_peaks.cu', 0.0):.2f} "
        f"s; 0 = cached)")

    # 3. Kernel vs plain version on the card.
    rng = np.random.default_rng(SEED)
    state_dict = convert_openpose(random_openpose_state_dict(rng))
    frames = rng.integers(0, 256, (BATCH,) + FRAME + (3,), dtype=np.uint8)

    model_est = OpenPoseEstimator(params=state_dict)
    resized, _ = model_est._resize_in(frames)
    from terran_tpu_torch.ops.pose_decode import normalize_images

    with torch.inference_mode():
        _, heat = model_est.model(
            normalize_images(resized).to(model_est.model.compute_dtype)
        )
    heat19 = heat.float()
    strided = heat19[..., :18]  # the pose path's own view, not a copy
    main_heat = strided.contiguous()
    n, h, w, parts = main_heat.shape
    k_main = model_est.max_peaks
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

    # Times at K=32 and K=128 on the pose path's own strided view.
    ms = {k: time_ms(lambda k=k: fp.find_peaks_fused(strided, 0.1, k))
          for k in (k_main, 128)}
    plain_ms = time_ms(
        lambda: fp.find_peaks_fused_plain(main_heat, 0.1, k_main)
    )
    bound_ms, bound_by = kernel_bound_ms(n * parts, h, w, k_main)
    log(f"timing at the main-path shape ({card}): find_peaks_fused "
        f"{ms[k_main]:.4f} ms at K={k_main}, {ms[128]:.4f} ms at K=128, "
        f"plain version {plain_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by})")

    # 4. The main path, bf16, through the task API.
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
    for k in (k_main, 128):
        _, kernel_ms[k], names = profile_call(
            lambda k=k: fp.find_peaks_fused(strided, 0.1, k), 20)
        log(f"kernels at K={k} ({card}): {kernel_ms[k]:.4f} ms a call ("
            + ", ".join(f"{name} {t:.4f} ms"
                        for name, t in sorted(names.items()))
            + ")")

    # 7. Results.
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
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
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
