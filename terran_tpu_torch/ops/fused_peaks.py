"""Fused x8 bicubic upsample + peak scan: CUDA kernel and plain version.

``find_peaks_fused(heat, threshold, K)`` computes what
``find_peaks(upsample_bicubic(heat, 8), threshold, K)`` computes, in the
convention of ``terran_tpu/ops/fused_peaks.py::find_peaks_fused``
(invalid slots carry coords 0), without materialising the x8 field:

- for a CUDA tensor it launches ``csrc/fused_peaks.cu`` (built by ``nvcc``
  at first use), which writes, per (plane, tile), the tile's exact peak
  count and its strongest K peaks in (score desc, row-major index asc)
  order; the tiles of a plane are merged here with the same total order,
  then the kept set is re-ordered row-major;
- for a CPU tensor it runs the plain version, which is what the kernel is
  held to: the same kept set, bit-identical scores, and
  ``overflow = count > K``.

One intended difference from the TPU kernel: that kernel pre-selects two
candidates per (source cell, upsampled row) and flags overflow when an
exact-tie plateau puts three in one such row piece; this kernel keeps
every candidate, so such a plateau is reported exactly.
"""

import ctypes

import numpy as np
import torch

from terran_tpu_torch.ops.pose_decode import find_peaks
from terran_tpu_torch.ops.upsample import _phase_table, upsample_bicubic

_BIG = 2 ** 31 - 1
_SOURCE = "fused_peaks.cu"


def fused_peaks_enabled(setting=None):
    """Resolve the ``fused_peaks`` setting: 'auto' and 'on' select the fused
    path (the CUDA kernel for CUDA tensors), 'off' the materialised one."""
    if setting is None:
        from terran_tpu_torch.config import get_config

        setting = get_config().fused_peaks
    if setting in ("auto", "on"):
        return True
    if setting == "off":
        return False
    raise ValueError(f"fused_peaks must be 'auto', 'on' or 'off', "
                     f"got {setting!r}")


def find_peaks_fused_plain(heatmaps, threshold, max_peaks, factor=8):
    """The plain PyTorch version: materialise the x8 field, then
    ``find_peaks``; invalid slots get coords 0."""
    nd = heatmaps.dim()
    up = upsample_bicubic(heatmaps.to(torch.float32), factor,
                          axes=(nd - 3, nd - 2))
    coords, scores, valid, overflow = find_peaks(up, threshold, max_peaks)
    coords = torch.where(valid[..., None], coords, 0)
    return coords, scores, valid, overflow


def _library():
    from terran_tpu_torch.utils.cuda_build import load_library

    lib = load_library(_SOURCE)
    if not getattr(lib, "_signatures_set", False):
        lib.fused_peaks_num_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fused_peaks_num_tiles.restype = ctypes.c_int
        lib.fused_peaks_factor.argtypes = []
        lib.fused_peaks_factor.restype = ctypes.c_int
        lib.fused_peaks_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.fused_peaks_launch.restype = ctypes.c_int
        lib._signatures_set = True
    return lib


def fused_peak_candidates(planes, threshold, max_peaks):
    """Launch the kernel on (M, h, w) float32 CUDA planes. Returns per-tile
    (scores (M, T, K) float32, lin (M, T, K) int32, counts (M, T) int32);
    unused slots hold (-inf, 2**31 - 1)."""
    if planes.device.type != "cuda":
        raise ValueError(f"planes must be a CUDA tensor, got {planes.device}")
    if planes.dtype != torch.float32 or planes.dim() != 3:
        raise ValueError("planes must be (M, h, w) float32, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    m, h, w = planes.shape
    if m == 0 or h < 1 or w < 1 or max_peaks < 1:
        raise ValueError(f"empty input: planes {tuple(planes.shape)}, "
                         f"max_peaks {max_peaks}")
    lib = _library()
    factor = lib.fused_peaks_factor()
    if (h * factor) * (w * factor) >= _BIG:
        raise ValueError(f"field {h}x{w} too large for int32 indices")
    tiles = lib.fused_peaks_num_tiles(h, w)
    dev = planes.device
    scores = torch.empty((m, tiles, max_peaks), dtype=torch.float32,
                         device=dev)
    lin = torch.empty((m, tiles, max_peaks), dtype=torch.int32, device=dev)
    counts = torch.empty((m, tiles), dtype=torch.int32, device=dev)
    bases, weights = _phase_table(factor)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    bases = np.ascontiguousarray(bases, dtype=np.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_peaks_launch(
            planes.data_ptr(), scores.data_ptr(), lin.data_ptr(),
            counts.data_ptr(), m, h, w, float(threshold), int(max_peaks),
            weights.ctypes.data, bases.ctypes.data, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_peaks kernel launch failed: CUDA error "
                           f"{err}")
    find_peaks_fused.launches += 1
    return scores, lin, counts


def merge_candidates(scores, lin, counts, max_peaks, up_w):
    """Per-tile candidates -> the plane's (coords, scores, valid,
    overflow), planes leading. Ties are broken explicitly: a stable sort by
    index, then a stable sort by descending score, gives the (score desc,
    index asc) order of ``find_peaks``' selection."""
    m = scores.shape[0]
    s = scores.reshape(m, -1)
    l = lin.reshape(m, -1)
    order = torch.sort(l, dim=1, stable=True).indices
    s, l = s.gather(1, order), l.gather(1, order)
    order = torch.sort(s, dim=1, descending=True, stable=True).indices
    order = order[:, :max_peaks]
    top_s, top_l = s.gather(1, order), l.gather(1, order)
    valid = top_s > float("-inf")

    # Re-order the kept set row-major (invalid slots last).
    position = torch.where(valid, top_l, _BIG)
    order = torch.sort(position, dim=1, stable=True).indices
    top_s, top_l, valid = (
        top_s.gather(1, order), top_l.gather(1, order),
        valid.gather(1, order),
    )
    coords = torch.stack([top_l // up_w, top_l % up_w], dim=-1)
    coords = torch.where(valid[..., None], coords, 0).to(torch.int32)
    top_s = torch.where(valid, top_s, 0.0)
    overflow = counts.sum(dim=1) > max_peaks
    return coords, top_s, valid, overflow


def find_peaks_fused(heatmaps, threshold, max_peaks, factor=8):
    """Fused equivalent of
    ``find_peaks(upsample_bicubic(heatmaps, factor), threshold, max_peaks)``.

    heatmaps: (..., h, w, P) SOURCE-resolution float maps (leading batch
    dims optional). Returns (coords (..., P, K, 2) int32 (y, x) in the
    UPSAMPLED grid, 0 in invalid slots; scores (..., P, K); valid
    (..., P, K) bool; overflow (..., P) bool), peaks ordered row-major per
    part. CPU tensors take the plain version; CUDA tensors launch the
    kernel (factor 8 only).
    """
    if heatmaps.dim() < 3:
        raise ValueError(f"expected (..., h, w, P) heatmaps, got "
                         f"{tuple(heatmaps.shape)}")
    if heatmaps.device.type == "cpu":
        return find_peaks_fused_plain(heatmaps, threshold, max_peaks, factor)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"no fused_peaks kernel for {heatmaps.device}")
    if factor != 8:
        raise ValueError(f"the CUDA kernel upsamples x8, got factor={factor}")

    batch_shape = heatmaps.shape[:-3]
    h, w, parts = heatmaps.shape[-3:]
    planes = heatmaps.movedim(-1, -3).reshape(-1, h, w)
    planes = planes.to(torch.float32).contiguous()
    scores, lin, counts = fused_peak_candidates(planes, threshold, max_peaks)
    coords, scores, valid, overflow = merge_candidates(
        scores, lin, counts, max_peaks, w * factor
    )
    out_shape = batch_shape + (parts,)
    return (
        coords.reshape(out_shape + (max_peaks, 2)),
        scores.reshape(out_shape + (max_peaks,)),
        valid.reshape(out_shape + (max_peaks,)),
        overflow.reshape(out_shape),
    )


# Kernel launches since the count was last set to 0.
find_peaks_fused.launches = 0
