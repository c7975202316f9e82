"""Fused x8 bicubic upsample + peak scan: CUDA kernels and plain versions.

``find_peaks_fused(heat, threshold, K)`` computes what
``find_peaks(upsample_bicubic(heat, 8), threshold, K)`` computes, in the
convention of ``terran_tpu/ops/fused_peaks.py::find_peaks_fused``
(invalid slots carry coords 0), without materialising the x8 field:

- for a CUDA tensor it makes two launches of ``csrc/fused_peaks.cu``
  (built by ``nvcc`` at first use) and no other device work beyond
  allocating its outputs and one workspace. The scan kernel reads the
  channel-last heatmaps in place, strides and all, and writes per
  (plane, tile) the tile's exact peak count and its strongest K peaks as
  64-bit keys in (score desc, row-major index asc) order; the merge
  kernel ranks the tiles' keys within each plane, keeps the first K and
  writes them row-major;
- for a CPU tensor it runs the plain version, which is what the kernels
  are held to: the same kept set, bit-identical scores, and
  ``overflow = count > K``.

``merge_candidates`` is the plain version of the merge kernel, on the
scan kernel's output as ``decode_tile_keys`` reads it; ``scan_tiles`` and
``merge_tiles`` launch one kernel each, so that the two can be checked
apart on the card.

One intended difference from the TPU kernel: that kernel pre-selects two
candidates per (source cell, upsampled row) and flags overflow when an
exact-tie plateau puts three in one such row piece; this kernel keeps
every candidate, so such a plateau is reported exactly.
"""

import ctypes

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


# The kernel's tile in source cells and its factor
# (csrc/fused_peaks.cu: kTileSrcRows, kTileSrcCols, kFactor).
TILE_SRC_ROWS, TILE_SRC_COLS, FACTOR = 4, 8, 8
_lib = None


def tap_reach():
    """Bound on |x8 upsampled value| / max |source value| over the 4x4 taps
    of any output pixel, ``max_r (sum_i |w_ri|) ** 2``, with a margin of
    2**-10 that covers the float32 rounding of the two FIR passes (under
    2**-20). A scan tile whose source patch times this stays below the
    threshold holds no candidate."""
    _, weights = _phase_table(FACTOR)
    return max(sum(abs(x) for x in row) for row in weights) ** 2 * (
        1 + 2 ** -10)


def num_tiles(h, w):
    """Tiles the kernel cuts an h x w source plane into."""
    return -(-h // TILE_SRC_ROWS) * -(-w // TILE_SRC_COLS)


def _library():
    """The built kernels, with ctypes signatures and the FIR taps set once
    per process."""
    global _lib
    if _lib is not None:
        return _lib
    from terran_tpu_torch.utils.cuda_build import load_library

    lib = load_library(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.fused_peaks_shape.argtypes = [c_int_p, c_int_p, c_int_p]
    lib.fused_peaks_shape.restype = None
    lib.fused_peaks_set_taps.argtypes = [ctypes.POINTER(ctypes.c_float),
                                         c_int_p, ctypes.c_float]
    lib.fused_peaks_set_taps.restype = None
    lib.fused_peaks_scan.argtypes = [
        ptr, i64, i64, i64, i64, i32, i32, i32, i32, ctypes.c_float, i32,
        ptr, ptr, ptr,
    ]
    lib.fused_peaks_scan.restype = i32
    lib.fused_peaks_merge.argtypes = [
        ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
    ]
    lib.fused_peaks_merge.restype = i32

    shape = [ctypes.c_int() for _ in range(3)]
    lib.fused_peaks_shape(*(ctypes.byref(v) for v in shape))
    if tuple(v.value for v in shape) != (TILE_SRC_ROWS, TILE_SRC_COLS,
                                         FACTOR):
        raise RuntimeError(f"{_SOURCE} tiles by {[v.value for v in shape]}, "
                           f"the wrapper by {TILE_SRC_ROWS, TILE_SRC_COLS}")
    bases, weights = _phase_table(FACTOR)
    lib.fused_peaks_set_taps(
        (ctypes.c_float * (4 * FACTOR))(*(x for row in weights for x in row)),
        (ctypes.c_int * FACTOR)(*bases),
        tap_reach(),
    )
    _lib = lib
    return lib


def _check(err, name):
    if err != 0:
        raise RuntimeError(f"fused_peaks {name} kernel launch failed: CUDA "
                           f"error {err}")
    find_peaks_fused.launches += 1


def _source(heatmaps):
    """(..., h, w, P) CUDA heatmaps as an (n, h, w, P) float32 view (a copy
    only where the dtype differs or the leading dims do not flatten)."""
    if heatmaps.device.type != "cuda":
        raise ValueError(f"heatmaps must be a CUDA tensor, got "
                         f"{heatmaps.device}")
    if heatmaps.dim() < 3:
        raise ValueError(f"expected (..., h, w, P) heatmaps, got "
                         f"{tuple(heatmaps.shape)}")
    h, w, parts = heatmaps.shape[-3:]
    src = (heatmaps if heatmaps.dim() == 4
           else heatmaps.reshape(-1, h, w, parts))
    if src.dtype != torch.float32:
        src = src.to(torch.float32)
    if h < 1 or w < 1:
        raise ValueError(f"empty field in heatmaps {tuple(heatmaps.shape)}")
    if (h * FACTOR) * (w * FACTOR) >= _BIG:
        raise ValueError(f"field {h}x{w} too large for int32 indices")
    return src


def _scan(lib, src, threshold, k, tile_keys, tile_counts, stream):
    n, h, w, parts = src.shape
    s_b, s_h, s_w, s_c = src.stride()
    _check(lib.fused_peaks_scan(
        src.data_ptr(), s_b, s_h, s_w, s_c, n, parts, h, w, threshold, k,
        tile_keys, tile_counts, stream,
    ), "scan")


def _merge(lib, tile_keys, tile_counts, m, tiles, k, up_w, kept, outs,
           stream):
    coords, scores, valid, overflow = outs
    _check(lib.fused_peaks_merge(
        tile_keys, tile_counts, m, tiles, k, up_w, kept, coords.data_ptr(),
        scores.data_ptr(), valid.data_ptr(), overflow.data_ptr(), stream,
    ), "merge")


def _outputs(shape, k, device):
    """coords, scores, valid and overflow for planes of ``shape``."""
    shape = tuple(shape)
    return (
        torch.empty(shape + (k, 2), dtype=torch.int32, device=device),
        torch.empty(shape + (k,), dtype=torch.float32, device=device),
        torch.empty(shape + (k,), dtype=torch.bool, device=device),
        torch.empty(shape, dtype=torch.bool, device=device),
    )


def _stream(device):
    return torch._C._cuda_getCurrentRawStream(device.index)


def scan_tiles(heatmaps, threshold, max_peaks):
    """Launch the scan kernel alone on (..., h, w, P) CUDA heatmaps.
    Returns (tile_keys (M, T, K) int64, tile_counts (M, T) int32) for the
    M = (images x P) planes and T tiles: each tile's exact peak count and
    its top min(count, K) keys in descending order; later slots are
    unset."""
    lib = _library()
    src = _source(heatmaps)
    n, h, w, parts = src.shape
    m, tiles, k = n * parts, num_tiles(h, w), int(max_peaks)
    keys = torch.empty((m, tiles, k), dtype=torch.int64, device=src.device)
    counts = torch.empty((m, tiles), dtype=torch.int32, device=src.device)
    with torch.cuda.device(src.device):
        _scan(lib, src, float(threshold), k, keys.data_ptr(),
              counts.data_ptr(), _stream(src.device))
    return keys, counts


def merge_tiles(tile_keys, tile_counts, up_w):
    """Launch the merge kernel alone on ``scan_tiles``' output. Returns the
    planes' (coords (M, K, 2), scores (M, K), valid (M, K), overflow
    (M,)), as ``merge_candidates`` computes them."""
    lib = _library()
    m, tiles, k = tile_keys.shape
    dev = tile_keys.device
    kept = torch.empty((m, k), dtype=torch.int64, device=dev)
    outs = _outputs((m,), k, dev)
    with torch.cuda.device(dev):
        _merge(lib, tile_keys.data_ptr(), tile_counts.data_ptr(), m, tiles,
               k, int(up_w), kept.data_ptr(), outs, _stream(dev))
    return outs


def decode_tile_keys(tile_keys, tile_counts):
    """Keys -> the (scores float32, lin int32) per-tile candidates that
    ``merge_candidates`` takes; slots past a tile's min(count, K) become
    (-inf, 2**31 - 1)."""
    k = tile_keys.shape[-1]
    used = (torch.arange(k, device=tile_keys.device)
            < tile_counts.to(torch.int64)[..., None])
    keys = torch.where(used, tile_keys, 0)
    hi = (keys >> 32) & 0xFFFFFFFF
    lo = keys & 0xFFFFFFFF
    bits = torch.where(hi >= 2 ** 31, hi - 2 ** 31, 0xFFFFFFFF - hi)
    bits = torch.where((lo & 1) == 1, 2 ** 31, bits)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)  # as int32
    scores = bits.to(torch.int32).view(torch.float32)
    lin = (_BIG - (lo >> 1)).to(torch.int32)
    return (torch.where(used, scores, float("-inf")),
            torch.where(used, lin, _BIG))


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

    k = int(max_peaks)
    if k < 0:
        raise ValueError(f"max_peaks must be >= 0, got {max_peaks}")
    lib = _library()
    src = _source(heatmaps)
    outs = _outputs(heatmaps.shape[:-3] + heatmaps.shape[-1:], k,
                    src.device)
    if src.shape[0] * src.shape[3] > 0:
        with torch.cuda.device(src.device):
            _run(lib, src, float(threshold), k, outs)
    return outs


def _run(lib, src, threshold, k, outs):
    """Both launches on the (n, h, w, P) source into ``outs``."""
    n, h, w, parts = src.shape
    m, tiles, dev = n * parts, num_tiles(h, w), src.device
    # One workspace: the tile lists (m, tiles, k), the kept sets (m, k),
    # then the tile counts (m, tiles) as int32.
    work = torch.empty(m * (tiles * k + k) + (m * tiles + 1) // 2,
                       dtype=torch.int64, device=dev)
    keys = work.data_ptr()
    kept = keys + 8 * m * tiles * k
    counts = kept + 8 * m * k
    stream = _stream(dev)
    _scan(lib, src, threshold, k, keys, counts, stream)
    _merge(lib, keys, counts, m, tiles, k, w * FACTOR, kept, outs, stream)


# Kernel launches (scan and merge each count one) since the count was
# last set to 0.
find_peaks_fused.launches = 0
