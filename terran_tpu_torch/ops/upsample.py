"""Integer-factor bicubic upsampling with torch's bicubic semantics.

The reference upsamples PAFs and heatmaps x8 with
``F.interpolate(mode='bicubic', align_corners=False)``: the Keys kernel
with A = -0.75, half-pixel centres ``src = (dst + 0.5) / 8 - 0.5`` and
clamped border taps. For a fixed integer factor the fractional phase
cycles through ``factor`` values, so the op is ``factor`` fixed 4-tap FIR
filters per axis. This is the same FIR as ``terran_tpu/ops/upsample.py``
with the same float32 weights and accumulation order
``((w0*t0 + w1*t1) + w2*t2) + w3*t3``, H axis then W axis; the CUDA
peak-scan kernel (``csrc/fused_peaks.cu``) evaluates it in that order too,
so its values are bit-identical to this function's on the card.
``F.interpolate`` itself sums in another order and differs by ulps.
"""

import functools

import numpy as np
import torch

from terran_tpu_torch.runtime import device_constant


def _cubic_kernel(x, a=-0.75):
    x = abs(float(x))
    if x <= 1.0:
        return (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0
    if x < 2.0:
        return a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a
    return 0.0


@functools.lru_cache(maxsize=8)
def _phase_table(factor):
    """Per-phase (base offset, 4 tap weights) for the half-pixel mapping.
    Weights are the float32 values the FIR multiplies by, as Python floats."""
    bases, weights = [], []
    for r in range(factor):
        src = (r + 0.5) / factor - 0.5
        base = int(np.floor(src))
        t = src - base
        w = [_cubic_kernel(t + 1.0), _cubic_kernel(t), _cubic_kernel(1.0 - t),
             _cubic_kernel(2.0 - t)]
        bases.append(base)
        weights.append(tuple(float(np.float32(v)) for v in w))
    return tuple(bases), tuple(weights)


def _upsample_axis(x, factor, axis):
    n = x.shape[axis]
    bases, weights = _phase_table(factor)
    # Taps reach from base-1 to base+2 with base in {-1, 0}: clamped
    # indices replicate the edge like torch's border taps.
    positions = torch.arange(n, device=x.device)

    def tap(offset):
        return x.index_select(axis, (positions + offset).clamp_(0, n - 1))

    phases = []
    for base, w in zip(bases, weights):
        acc = (
            w[0] * tap(base - 1) + w[1] * tap(base)
            + w[2] * tap(base + 1) + w[3] * tap(base + 2)
        )
        phases.append(acc)

    stacked = torch.stack(phases, dim=axis + 1)  # (..., n, factor, ...)
    new_shape = list(x.shape)
    new_shape[axis] = n * factor
    return stacked.reshape(new_shape)


def upsample_bicubic(x, factor, axes=(1, 2)):
    """Bicubic upsample of NHWC float ``x`` by an integer ``factor`` along
    ``axes`` (H first, then W), numerically matching
    ``F.interpolate(mode='bicubic', align_corners=False)`` to float32
    rounding."""
    for axis in axes:
        x = _upsample_axis(x, factor, axis)
    return x


def sample_bicubic(maps, factor, ys, xs):
    """Values of ``upsample_bicubic(maps, factor, axes=(1, 2))`` at integer
    positions, without building the upsampled planes (the port of
    ``terran_tpu/ops/upsample.py::sample_bicubic``).

    The same four taps a sample and the same float32 accumulation order as
    :func:`_upsample_axis` (H inner, then W), so the values are bit for
    bit the materialised field's on any device.

    maps: (M, H, W) float planes. ys, xs: (M, ...) integer positions in
    the upsampled grid, within [0, H*factor) and [0, W*factor). Returns
    (M, ...) values.
    """
    m, h, w = maps.shape
    bases, weights = _phase_table(factor)
    bases = device_constant(bases, torch.int64, maps.device)
    weights = device_constant(weights, maps.dtype, maps.device)
    flat = maps.reshape(m, h * w)

    def taps(positions, size):
        positions = positions.to(torch.int64)
        phase = positions % factor
        base = positions // factor + bases[phase]
        return ([(base + offset).clamp_(0, size - 1)
                 for offset in (-1, 0, 1, 2)], weights[phase])

    ty, wy = taps(ys, h)
    tx, wx = taps(xs, w)

    def at(index):
        return flat.gather(1, index.reshape(m, -1)).reshape(index.shape)

    cols = []
    for tx_col in tx:
        rows = [at(t * w + tx_col) for t in ty]
        cols.append(wy[..., 0] * rows[0] + wy[..., 1] * rows[1]
                    + wy[..., 2] * rows[2] + wy[..., 3] * rows[3])
    return (wx[..., 0] * cols[0] + wx[..., 1] * cols[1]
            + wx[..., 2] * cols[2] + wx[..., 3] * cols[3])
