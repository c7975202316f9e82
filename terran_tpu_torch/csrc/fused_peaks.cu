// Fused x8 bicubic upsample + 4-neighbour peak scan, for sm_90a.
//
// Replaces the Pallas kernel terran_tpu/ops/fused_peaks.py::_band_kernel
// (through _fused_peak_candidates and find_peaks_fused). Same function:
// the local maxima (`>=` against the 4 neighbours, `>=` threshold, 1-px
// interior rule) of the x8 bicubic upsample (A = -0.75, half-pixel,
// clamped borders) of each heatmap plane, without writing the x8 field to
// device memory. Each block handles one (plane, tile) and writes the
// tile's exact peak count and its strongest K peaks, ordered by (score
// desc, row-major index asc). The host wrapper
// (terran_tpu_torch/ops/fused_peaks.py) merges the tiles of a plane with
// the same total order and re-orders the kept set row-major.
//
// What bounds it on an H100: at the pose main path (144 planes of 23x40,
// 8.5 M upsampled pixels) the work is ~1e8 float32 operations and ~0.5 MB
// read, a few microseconds at the card's rates, so launch latency and
// the per-block serial steps (two FIR passes through shared memory, K
// block-wide argmax rounds) dominate. The design keeps everything of a
// tile in shared memory (~21 KB), reads each source pixel from device
// memory once per tile, runs thousands of small blocks so every SM is
// busy, and stops the K rounds at the tile's exact peak count, which is
// a handful on real heatmaps.
//
// Numerics: the FIR is written with __fmul_rn/__fadd_rn in the order
// ((w0*t0 + w1*t1) + w2*t2) + w3*t3, H axis then W axis, with the
// float32 tap weights the host passes from ops/upsample.py::_phase_table.
// That is exactly the arithmetic of the plain version
// (find_peaks(upsample_bicubic(...))) run as separate PyTorch kernels, so
// values and therefore knife-edge `>=` comparisons are bit-identical; a
// contracted FMA would change them by an ulp.
//
// Unlike the TPU kernel, nothing here pre-selects within a row piece: no
// plateau of exact ties can drop a candidate, and the overflow flag is
// exactly `count > K`.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kFactor = 8;
constexpr int kTileSrcRows = 4;                     // source rows per tile
constexpr int kTileSrcCols = 16;                    // source columns per tile
constexpr int kTileRows = kTileSrcRows * kFactor;   // 32 upsampled rows
constexpr int kTileCols = kTileSrcCols * kFactor;   // 128 upsampled columns
constexpr int kPad = 2;                             // FIR reach in source px
constexpr int kSrcRows = kTileSrcRows + 2 * kPad;
constexpr int kSrcCols = kTileSrcCols + 2 * kPad;
constexpr int kValRows = kTileRows + 2;             // + 1 halo row each side
constexpr int kValCols = kTileCols + 2;             // + 1 halo column each side
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kTileRows * kTileCols / kThreads;  // 16
static_assert(kPerThread <= 32, "one mask bit per owned pixel");
static_assert(kTileRows * kTileCols % kThreads == 0, "even pixel split");

struct PhaseTable {
  float w[kFactor][4];
  int base[kFactor];
};

__device__ __forceinline__ float fir4(const float (&w)[4], float t0, float t1,
                                      float t2, float t3) {
  float acc = __fmul_rn(w[0], t0);
  acc = __fadd_rn(acc, __fmul_rn(w[1], t1));
  acc = __fadd_rn(acc, __fmul_rn(w[2], t2));
  acc = __fadd_rn(acc, __fmul_rn(w[3], t3));
  return acc;
}

// Total order of candidates: higher score first, then smaller row-major
// index. Indices are unique, so no two candidates tie.
__device__ __forceinline__ bool before(float sa, int la, float sb, int lb) {
  return sa > sb || (sa == sb && la < lb);
}

__global__ void __launch_bounds__(kThreads)
fused_peaks_kernel(const float* __restrict__ planes,
                   float* __restrict__ out_score, int* __restrict__ out_lin,
                   int* __restrict__ out_count, int h, int w, int tiles_x,
                   int n_tiles, float threshold, int k_out, PhaseTable pt) {
  __shared__ float src[kSrcRows][kSrcCols];
  __shared__ float hq[kValRows][kSrcCols];
  __shared__ float val[kValRows][kValCols];
  __shared__ float red_s[kWarps];
  __shared__ int red_l[kWarps];
  __shared__ int red_n[kWarps];
  __shared__ float pick_s;
  __shared__ int pick_l;
  __shared__ int total;

  const int plane = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int sy0 = (tile / tiles_x) * kTileSrcRows;
  const int sx0 = (tile % tiles_x) * kTileSrcCols;
  const int y0 = sy0 * kFactor;
  const int x0 = sx0 * kFactor;
  const int up_h = h * kFactor;
  const int up_w = w * kFactor;
  const float* p = planes + static_cast<size_t>(plane) * h * w;
  const int tid = threadIdx.x;

  // 1. Source patch, rows sy0-2 .. sy0+5 and columns sx0-2 .. sx0+17,
  //    with clamped indices (torch's replicated border taps).
  for (int i = tid; i < kSrcRows * kSrcCols; i += kThreads) {
    const int r = i / kSrcCols, c = i % kSrcCols;
    const int gy = min(max(sy0 - kPad + r, 0), h - 1);
    const int gx = min(max(sx0 - kPad + c, 0), w - 1);
    src[r][c] = p[gy * w + gx];
  }
  __syncthreads();

  // 2. H-axis FIR: upsampled rows y0-1 .. y0+32 at every patch column.
  //    Row Y lies in source row yb = floor(Y / 8) at phase ry = Y mod 8
  //    (Y >= -1, so the +8 keeps the division a floor).
  for (int i = tid; i < kValRows * kSrcCols; i += kThreads) {
    const int uy = i / kSrcCols, c = i % kSrcCols;
    const int Y = y0 - 1 + uy;
    const int yb = (Y + kFactor) / kFactor - 1;
    const int ry = (Y + kFactor) % kFactor;
    const int r = yb + pt.base[ry] - 1 - (sy0 - kPad);  // patch row of tap 0
    hq[uy][c] = fir4(pt.w[ry], src[r][c], src[r + 1][c], src[r + 2][c],
                     src[r + 3][c]);
  }
  __syncthreads();

  // 3. W-axis FIR: upsampled columns x0-1 .. x0+128.
  for (int i = tid; i < kValRows * kValCols; i += kThreads) {
    const int uy = i / kValCols, ux = i % kValCols;
    const int X = x0 - 1 + ux;
    const int xb = (X + kFactor) / kFactor - 1;
    const int rx = (X + kFactor) % kFactor;
    const int c = xb + pt.base[rx] - 1 - (sx0 - kPad);
    val[uy][ux] = fir4(pt.w[rx], hq[uy][c], hq[uy][c + 1], hq[uy][c + 2],
                       hq[uy][c + 3]);
  }
  __syncthreads();

  // 4. Peak rule. Thread tid owns tile pixels j * 256 + tid, one mask bit
  //    each. The tile's last rows and columns may lie past the field
  //    (their values come from clamped taps): the source-cell checks
  //    exclude them explicitly, the interior rule the 1-px border.
  unsigned mask = 0;
  int n_mine = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int q = j * kThreads + tid;
    const int ty = q / kTileCols, tx = q % kTileCols;
    const int Y = y0 + ty, X = x0 + tx;
    if (Y / kFactor < h && X / kFactor < w && Y >= 1 && Y <= up_h - 2 &&
        X >= 1 && X <= up_w - 2) {
      const float v = val[ty + 1][tx + 1];
      if (v >= val[ty][tx + 1] && v >= val[ty + 2][tx + 1] &&
          v >= val[ty + 1][tx] && v >= val[ty + 1][tx + 2] &&
          v >= threshold) {
        mask |= 1u << j;
        ++n_mine;
      }
    }
  }

  // 5. Exact peak count of the tile.
  for (int off = 16; off > 0; off >>= 1)
    n_mine += __shfl_down_sync(0xffffffffu, n_mine, off);
  if ((tid & 31) == 0) red_n[tid >> 5] = n_mine;
  __syncthreads();
  if (tid == 0) {
    int t = 0;
    for (int i = 0; i < kWarps; ++i) t += red_n[i];
    total = t;
  }
  __syncthreads();
  const int count = total;
  const size_t slot = static_cast<size_t>(plane) * n_tiles + tile;
  if (tid == 0) out_count[slot] = count;
  float* tile_score = out_score + slot * k_out;
  int* tile_lin = out_lin + slot * k_out;
  const int take = min(count, k_out);

  // 6. Strongest `take` peaks: round k picks the first candidate in the
  //    total order that comes strictly after round k-1's pick. No
  //    capacity, so nothing can be dropped silently. (+inf, -1) precedes
  //    every candidate.
  float prev_s = INFINITY;
  int prev_l = -1;
  for (int k = 0; k < take; ++k) {
    float bs = -INFINITY;
    int bl = INT_MAX;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if ((mask >> j) & 1u) {
        const int q = j * kThreads + tid;
        const int ty = q / kTileCols, tx = q % kTileCols;
        const float v = val[ty + 1][tx + 1];
        const int l = (y0 + ty) * up_w + (x0 + tx);
        if (before(prev_s, prev_l, v, l) && before(v, l, bs, bl)) {
          bs = v;
          bl = l;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int ol = __shfl_down_sync(0xffffffffu, bl, off);
      if (before(os, ol, bs, bl)) {
        bs = os;
        bl = ol;
      }
    }
    if ((tid & 31) == 0) {
      red_s[tid >> 5] = bs;
      red_l[tid >> 5] = bl;
    }
    __syncthreads();
    if (tid == 0) {
      float s = red_s[0];
      int l = red_l[0];
      for (int i = 1; i < kWarps; ++i) {
        if (before(red_s[i], red_l[i], s, l)) {
          s = red_s[i];
          l = red_l[i];
        }
      }
      tile_score[k] = s;
      tile_lin[k] = l;
      pick_s = s;
      pick_l = l;
    }
    __syncthreads();
    prev_s = pick_s;
    prev_l = pick_l;
  }
  for (int k = take + tid; k < k_out; k += kThreads) {
    tile_score[k] = -INFINITY;
    tile_lin[k] = INT_MAX;
  }
}

}  // namespace

extern "C" {

// Tiles per plane; the caller allocates (m, tiles, k_out) outputs.
int fused_peaks_num_tiles(int h, int w) {
  return ((h + kTileSrcRows - 1) / kTileSrcRows) *
         ((w + kTileSrcCols - 1) / kTileSrcCols);
}

int fused_peaks_factor() { return kFactor; }

// planes: (m, h, w) float32, contiguous, on the device.
// out_score (m, tiles, k_out) float32, out_lin (m, tiles, k_out) int32,
// out_count (m, tiles) int32. weights: host (8, 4) float32, bases: host
// (8,) int32. Returns cudaGetLastError() after the launch.
int fused_peaks_launch(const float* planes, float* out_score, int* out_lin,
                       int* out_count, int m, int h, int w, float threshold,
                       int k_out, const float* weights, const int* bases,
                       void* stream) {
  PhaseTable pt;
  for (int r = 0; r < kFactor; ++r) {
    for (int i = 0; i < 4; ++i) pt.w[r][i] = weights[r * 4 + i];
    pt.base[r] = bases[r];
  }
  const int tiles_x = (w + kTileSrcCols - 1) / kTileSrcCols;
  const int n_tiles = fused_peaks_num_tiles(h, w);
  const long long blocks = static_cast<long long>(m) * n_tiles;
  if (blocks <= 0 || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  fused_peaks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      planes, out_score, out_lin, out_count, h, w, tiles_x, n_tiles,
      threshold, k_out, pt);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
