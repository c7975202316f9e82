// Fused x8 bicubic upsample + 4-neighbour peak scan, for sm_90a.
//
// Replaces the Pallas kernel terran_tpu/ops/fused_peaks.py::_band_kernel
// (through _fused_peak_candidates) and the top-K merge of
// find_peaks_fused there. Same function: the local maxima (`>=` against
// the 4 neighbours, `>=` threshold, 1-px interior rule) of the x8 bicubic
// upsample (A = -0.75, half-pixel, clamped borders) of each heatmap
// plane, the strongest K of them by (score desc, row-major index asc),
// re-ordered row-major, without writing the x8 field to device memory.
// Two kernels, two launches per call:
//
// 1. scan_kernel, one block per (plane, tile of 4x8 source cells = 32x64
//    upsampled pixels). It reads the tile's source patch straight from
//    the caller's channel-last (n, h, w, C) layout with its strides. A
//    tile whose patch cannot reach the threshold (every value it feeds is
//    at most `reach` times its largest magnitude) writes count 0 and
//    stops there; the others run the H FIR into shared memory. For the W FIR and the peak rule a
//    thread owns one tile column, whose phase and taps are fixed, and 8
//    rows of it, carrying the rows above and below in registers. The
//    block compacts the tile's candidates into shared memory (warp
//    ballots and a block prefix sum) as 64-bit keys and writes the tile's
//    exact count and its top min(count, K) keys in order. Selection is by
//    rank: each candidate counts the candidates whose key is larger and
//    is written at that slot if it is below K. The block's barriers are a
//    fixed set, whatever K and the count; the rank loop's cost grows with
//    the tile's count (at most 2048, a tile that is one plateau), not K.
// 2. merge_kernel, one block per plane. A key's rank in its plane is its
//    index in its own tile's list plus a binary search into each other
//    tile's list; keys of rank below K are the kept set. The kept set is
//    ranked again by row-major index, and the block writes coords,
//    scores, valid and overflow in the (plane, K) layout. The lists are
//    staged in shared memory when they fit (at most 1024 tiles and 2048
//    listed keys), and so is the kept set (K <= 2048); otherwise the same
//    steps use the caller's workspace in device memory, so no
//    shared-memory capacity bounds K or the field. At the pose main path
//    staging takes the merge from ~0.031 to ~0.012 ms on an H100: the
//    binary searches are chains of dependent loads.
//
// The key: the high word holds the score's bits mapped so that unsigned
// order is float order (sign bit flipped for positives, all bits for
// negatives), the low word (INT_MAX - index) << 1. One unsigned compare
// gives (score desc, index asc). -0.0 is keyed as +0.0, since the plain
// version's sort treats them as a tie; bit 0 of the low word remembers
// the sign so the score is written back as it was. A NaN is never a
// candidate (`>=` is false).
//
// What bounds it on an H100: at the pose main path (144 planes of 23x40,
// 8.5 M upsampled pixels) the FIR and comparisons are ~1e8 float32
// operations and ~0.5 MB is read, under 2 us at the card's rates. The
// index arithmetic, shared-memory traffic and barriers around them cost
// several times the FIR's own instructions, and launch latency and the
// busiest tile's rank loop (about count^2 / 256 compares a thread) add to
// that; the column-per-thread layout keeps the per-pixel work to the FIR,
// one shared load for the row below, two for the sides and the compares.
// The 32x64 tile puts a 184x320 field on 6x5 tiles, with 4% of their
// pixels past the field; shared memory is ~27 KB a scan block and ~46 KB
// a merge block.
//
// Numerics: the FIR is written with __fmul_rn/__fadd_rn in the order
// ((w0*t0 + w1*t1) + w2*t2) + w3*t3, H axis then W axis, with the float32
// tap weights from ops/upsample.py::_phase_table (set once per process by
// fused_peaks_set_taps). That is exactly the arithmetic of the plain
// version (find_peaks(upsample_bicubic(...))) run as separate PyTorch
// kernels, so values and therefore knife-edge `>=` comparisons are
// bit-identical; a contracted FMA would change them by an ulp.
//
// Unlike the TPU kernel, nothing here pre-selects within a row piece: no
// plateau of exact ties can drop a candidate, and the overflow flag is
// exactly `count > K`. A non-finite kept score (+-inf) takes its slot in
// the order but is written as invalid, as the plain version does.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kFactor = 8;
constexpr int kTileSrcRows = 4;                     // source rows per tile
constexpr int kTileSrcCols = 8;                     // source columns per tile
constexpr int kTileRows = kTileSrcRows * kFactor;   // 32 upsampled rows
constexpr int kTileCols = kTileSrcCols * kFactor;   // 64 upsampled columns
constexpr int kTilePixels = kTileRows * kTileCols;  // 2048
constexpr int kPad = 2;                             // FIR reach in source px
constexpr int kSrcRows = kTileSrcRows + 2 * kPad;
constexpr int kSrcCols = kTileSrcCols + 2 * kPad;
constexpr int kValRows = kTileRows + 2;             // + 1 halo row each side
constexpr int kValCols = kTileCols + 2;             // + 1 halo column each side
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kTilePixels / kThreads;  // 8
constexpr int kGroups = kThreads / kTileCols;         // 4 row groups
constexpr int kWarpPixels = 32 * kPerThread;          // 256
// Resident scan blocks an SM must fit (at most 36 registers a thread):
// most tiles stop after the patch load, so blocks in flight hide its
// latency.
constexpr int kScanBlocksPerSM = 7;
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kMergeTiles = 1024;  // tile lengths kept in shared memory
constexpr int kMergeKeys = 2048;   // listed keys staged in shared memory
constexpr int kTilesPerThread = kMergeTiles / kMergeThreads;
static_assert(kPerThread <= 32, "one mask bit per owned pixel");
static_assert(kTilePixels % kThreads == 0, "even pixel split");
static_assert(kGroups * kPerThread == kTileRows, "a column of rows each");
static_assert(kTileCols % 32 == 0, "a warp spans one row group");

typedef unsigned long long Key;

struct PhaseTable {
  float w[kFactor][4];
  int base[kFactor];
  // Bound on |upsampled value| / max |source value| over any 4x4 taps,
  // with a margin above the float32 rounding of the two FIR passes.
  float reach;
};

PhaseTable g_taps;
bool g_taps_set = false;

__device__ __forceinline__ float fir4(const float (&w)[4], float t0, float t1,
                                      float t2, float t3) {
  float acc = __fmul_rn(w[0], t0);
  acc = __fadd_rn(acc, __fmul_rn(w[1], t1));
  acc = __fadd_rn(acc, __fmul_rn(w[2], t2));
  acc = __fadd_rn(acc, __fmul_rn(w[3], t3));
  return acc;
}

__device__ __forceinline__ Key make_key(float v, int lin) {
  unsigned bits = __float_as_uint(v);
  unsigned neg_zero = 0u;
  if (v == 0.0f) {  // -0.0 ties with +0.0
    neg_zero = bits >> 31;
    bits = 0u;
  }
  const unsigned hi = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  const unsigned lo = (static_cast<unsigned>(INT_MAX - lin) << 1) | neg_zero;
  return (static_cast<Key>(hi) << 32) | lo;
}

__device__ __forceinline__ float key_score(Key key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  unsigned bits = (hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi;
  if (key & 1ull) bits = 0x80000000u;
  return __uint_as_float(bits);
}

__device__ __forceinline__ int key_lin(Key key) {
  return INT_MAX - static_cast<int>(static_cast<unsigned>(key) >> 1);
}

__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

__global__ void __launch_bounds__(kThreads, kScanBlocksPerSM)
scan_kernel(const float* __restrict__ heat, long long s_b, long long s_h,
            long long s_w, long long s_c, int parts, int h, int w,
            int tiles_x, int n_tiles, float threshold, int k, PhaseTable pt,
            Key* __restrict__ tile_keys, int* __restrict__ tile_counts) {
  __shared__ float taps[kFactor][4];
  __shared__ int bases[kFactor];
  __shared__ float src[kSrcRows][kSrcCols];
  __shared__ float hq[kValRows][kSrcCols];
  __shared__ float val[kValRows][kValCols];
  __shared__ Key keys[kTilePixels];
  __shared__ int warp_n[kWarps];

  const int plane = blockIdx.x / n_tiles;
  const int tile = blockIdx.x % n_tiles;
  const int sy0 = (tile / tiles_x) * kTileSrcRows;
  const int sx0 = (tile % tiles_x) * kTileSrcCols;
  const int y0 = sy0 * kFactor;
  const int x0 = sx0 * kFactor;
  const int up_h = h * kFactor;
  const int up_w = w * kFactor;
  const float* p = heat + (plane / parts) * s_b + (plane % parts) * s_c;
  const int tid = threadIdx.x;

  // 1. Taps (static indices: a dynamically indexed parameter would be
  //    copied to local memory by every thread) and the source patch, rows
  //    sy0-2 .. sy0+5 and columns sx0-2 .. sx0+9, with clamped indices
  //    (torch's replicated border taps).
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < kFactor; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) taps[r][i] = pt.w[r][i];
      bases[r] = pt.base[r];
    }
  }
  bool reaches = false;  // may this tile hold a value >= threshold?
  for (int i = tid; i < kSrcRows * kSrcCols; i += kThreads) {
    const int r = i / kSrcCols, c = i % kSrcCols;
    const int gy = min(max(sy0 - kPad + r, 0), h - 1);
    const int gx = min(max(sx0 - kPad + c, 0), w - 1);
    const float s = p[gy * s_h + gx * s_w];
    src[r][c] = s;
    reaches |= !(fabsf(s) * pt.reach < threshold);  // NaN and inf reach
  }
  // Every value of the tile and its halo is a combination of the patch,
  // at most pt.reach * max |patch| in size: below the threshold, the tile
  // has no candidate and skips the rest (the common case on heatmaps
  // that are zero away from their peaks).
  const size_t slot = static_cast<size_t>(plane) * n_tiles + tile;
  if (!__syncthreads_or(reaches)) {
    if (tid == 0) tile_counts[slot] = 0;
    return;
  }

  // 2. H-axis FIR: upsampled rows y0-1 .. y0+32 at every patch column.
  //    Row Y lies in source row yb = floor(Y / 8) at phase ry = Y mod 8
  //    (Y >= -1, so the +8 keeps the division a floor).
  for (int i = tid; i < kValRows * kSrcCols; i += kThreads) {
    const int uy = i / kSrcCols, c = i % kSrcCols;
    const int Y = y0 - 1 + uy;
    const int yb = (Y + kFactor) / kFactor - 1;
    const int ry = (Y + kFactor) % kFactor;
    const int r = yb + bases[ry] - 1 - (sy0 - kPad);  // patch row of tap 0
    hq[uy][c] = fir4(taps[ry], src[r][c], src[r + 1][c], src[r + 2][c],
                     src[r + 3][c]);
  }
  __syncthreads();

  // 3. W-axis FIR. Thread tid owns tile column cx = tid % 64, whose phase
  //    (cx mod 8, as x0 is a multiple of 8) and taps are fixed, and the 8
  //    tile rows of its group g = tid / 64; groups 0 and 3 add the halo
  //    rows y0-1 and y0+32, threads 0..67 the halo columns x0-1, x0+64.
  const int cx = tid % kTileCols, g = tid / kTileCols;
  {
    const int rx = cx % kFactor;
    const int c = cx / kFactor + bases[rx] - 1 + kPad;  // patch column of tap 0
    const int first = g == 0 ? 0 : 1 + g * kPerThread;
    const int last = g == kGroups - 1 ? kValRows : 1 + (g + 1) * kPerThread;
    for (int uy = first; uy < last; ++uy) {
      val[uy][cx + 1] = fir4(taps[rx], hq[uy][c], hq[uy][c + 1],
                             hq[uy][c + 2], hq[uy][c + 3]);
    }
  }
  if (tid < 2 * kValRows) {
    const int uy = tid % kValRows;
    const int ux = tid < kValRows ? 0 : kValCols - 1;
    const int X = x0 - 1 + ux;
    const int xb = (X + kFactor) / kFactor - 1;
    const int rx = (X + kFactor) % kFactor;
    const int c = xb + bases[rx] - 1 - (sx0 - kPad);
    val[uy][ux] = fir4(taps[rx], hq[uy][c], hq[uy][c + 1], hq[uy][c + 2],
                       hq[uy][c + 3]);
  }
  __syncthreads();

  // 4. Peak rule down the thread's column, bit j for tile row g * 8 + j,
  //    the rows above and below carried in registers; the threshold is
  //    tested first, so a warp with no pixel above it reads no sides. The
  //    tile's last rows and columns may lie past the field (their values
  //    come from clamped taps): the source-cell checks exclude them
  //    explicitly, the interior rule the 1-px border.
  const int X = x0 + cx;
  const bool col_ok = X / kFactor < w && X >= 1 && X <= up_w - 2;
  unsigned mask = 0;
  float above = val[g * kPerThread][cx + 1];
  float v = val[g * kPerThread + 1][cx + 1];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int ty = g * kPerThread + j;
    const int Y = y0 + ty;
    const float below = val[ty + 2][cx + 1];
    if (v >= threshold && col_ok && Y / kFactor < h && Y >= 1 &&
        Y <= up_h - 2 && v >= above && v >= below &&
        v >= val[ty + 1][cx] && v >= val[ty + 1][cx + 2]) {
      mask |= 1u << j;
    }
    above = v;
    v = below;
  }

  // 5. Compact each warp's candidates by ballot into its own region of
  //    keys (a warp owns at most 32 * 8 pixels); warps without any skip.
  const int lane = tid & 31, warp = tid >> 5;
  Key* warp_keys = keys + warp * kWarpPixels;
  int n_warp = 0;
  if (__any_sync(0xffffffffu, mask != 0u)) {
    const unsigned lower = (1u << lane) - 1u;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const unsigned ballot = __ballot_sync(0xffffffffu, (mask >> j) & 1u);
      if ((mask >> j) & 1u) {
        const int ty = g * kPerThread + j;
        warp_keys[n_warp + __popc(ballot & lower)] =
            make_key(val[ty + 1][cx + 1], (y0 + ty) * up_w + X);
      }
      n_warp += __popc(ballot);
    }
  }
  if (lane == 0) warp_n[warp] = n_warp;
  __syncthreads();

  // 6. Exact count, and the top min(count, K) keys by rank: each warp
  //    ranks its own candidates against every region. Keys are unique, so
  //    the ranks are a permutation of [0, count).
  int count = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) count += warp_n[i];
  if (tid == 0) tile_counts[slot] = count;
  Key* out = tile_keys + slot * k;
  for (int i = lane; i < n_warp; i += 32) {
    const Key key = warp_keys[i];
    int rank = 0;
    for (int r = 0; r < kWarps; ++r) {
      const Key* region = keys + r * kWarpPixels;
      const int n = warp_n[r];
#pragma unroll 4
      for (int j = 0; j < n; ++j) rank += region[j] > key;
    }
    if (rank < k) out[rank] = key;
  }
}

// Number of keys in the descending list[0, len) that are larger than key.
__device__ __forceinline__ int count_larger(const Key* list, int len,
                                            Key key) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] > key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Row-major order of the kept set, non-finite scores last.
__device__ __forceinline__ Key row_major(Key key) {
  return (static_cast<Key>(!finite(key_score(key))) << 32) |
         static_cast<unsigned>(key_lin(key));
}

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const Key* __restrict__ tile_keys,
             const int* __restrict__ tile_counts, int n_tiles, int k,
             int up_w, Key* __restrict__ kept_keys, int* __restrict__ coords,
             float* __restrict__ scores, bool* __restrict__ valid,
             bool* __restrict__ overflow) {
  __shared__ Key s_keys[kMergeKeys];
  __shared__ Key s_kept[kMergeKeys];
  __shared__ int s_off[kMergeTiles];
  __shared__ int s_len[kMergeTiles];
  __shared__ unsigned short s_tile[kMergeKeys];
  __shared__ unsigned short s_busy[kMergeTiles];  // tiles with a list
  __shared__ long long warp_count[kMergeWarps];
  __shared__ int warp_listed[kMergeWarps];
  __shared__ int warp_busy[kMergeWarps];

  const int plane = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* counts = tile_counts + static_cast<size_t>(plane) * n_tiles;
  const Key* lists = tile_keys + static_cast<size_t>(plane) * n_tiles * k;

  // 1. The plane's exact count and its listed keys (sum of min(count,
  //    K)). With at most kMergeTiles tiles, thread tid owns tiles
  //    4 tid .. 4 tid + 3, and exclusive scans give each list's offset in
  //    s_keys and each non-empty list's slot in s_busy.
  const bool tiles_fit = n_tiles <= kMergeTiles;
  long long count = 0;
  int listed = 0, busy = 0;
  int lens[kTilesPerThread];
  if (tiles_fit) {
#pragma unroll
    for (int j = 0; j < kTilesPerThread; ++j) {
      const int t = tid * kTilesPerThread + j;
      const int c = t < n_tiles ? counts[t] : 0;
      count += c;
      lens[j] = min(c, k);
      listed += lens[j];
      busy += lens[j] > 0;
    }
  } else {
    for (int t = tid; t < n_tiles; t += kMergeThreads) {
      count += counts[t];
      listed += min(counts[t], k);
    }
  }
  int scan = listed, scan_busy = busy;  // inclusive scans within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, scan, off);
    const int b = __shfl_up_sync(0xffffffffu, scan_busy, off);
    if (lane >= off) {
      scan += v;
      scan_busy += b;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 31) {
    warp_listed[warp] = scan;
    warp_busy[warp] = scan_busy;
  }
  if (lane == 0) warp_count[warp] = count;
  __syncthreads();
  int off = scan - listed, slot = scan_busy - busy, n_listed = 0, n_busy = 0;
  count = 0;
#pragma unroll
  for (int i = 0; i < kMergeWarps; ++i) {
    off += i < warp ? warp_listed[i] : 0;
    slot += i < warp ? warp_busy[i] : 0;
    n_listed += warp_listed[i];
    n_busy += warp_busy[i];
    count += warp_count[i];
  }
  if (tiles_fit) {
#pragma unroll
    for (int j = 0; j < kTilesPerThread; ++j) {
      const int t = tid * kTilesPerThread + j;
      if (t < n_tiles) {
        s_off[t] = off;
        s_len[t] = lens[j];
        off += lens[j];
        if (lens[j] > 0) s_busy[slot++] = static_cast<unsigned short>(t);
      }
    }
  }
  const bool staged = tiles_fit && n_listed <= kMergeKeys;
  Key* kept = k <= kMergeKeys
                  ? s_kept
                  : kept_keys + static_cast<size_t>(plane) * k;
  __syncthreads();

  // 2. Plane rank of every listed key: its index in its own list plus a
  //    binary search into each other list. The kept set is ranks [0, K).
  //    The lists are staged in shared memory when they fit, so the
  //    searches' dependent loads do not wait on device memory.
  if (staged) {
    // Listed key e lies in the last busy tile whose offset is <= e; all
    // of the block's loads are in flight at once.
    for (int e = tid; e < n_listed; e += kMergeThreads) {
      int lo = 0, hi = n_busy - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_off[s_busy[mid]] <= e) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int t = s_busy[lo];
      s_keys[e] = lists[static_cast<size_t>(t) * k + (e - s_off[t])];
      s_tile[e] = static_cast<unsigned short>(t);
    }
    __syncthreads();
    for (int e = tid; e < n_listed; e += kMergeThreads) {
      const int t = s_tile[e];
      const Key key = s_keys[e];
      long long rank = e - s_off[t];
      for (int q = 0; q < n_busy && rank < k; ++q) {
        const int u = s_busy[q];
        if (u != t) rank += count_larger(s_keys + s_off[u], s_len[u], key);
      }
      if (rank < k) kept[rank] = key;
    }
  } else {
    for (int t = warp; t < n_tiles; t += kMergeWarps) {
      const int len = min(counts[t], k);
      for (int i = lane; i < len; i += 32) {
        const Key key = lists[static_cast<size_t>(t) * k + i];
        long long rank = i;
        for (int u = 0; u < n_tiles && rank < k; ++u) {
          if (u != t) {
            rank += count_larger(lists + static_cast<size_t>(u) * k,
                                 min(counts[u], k), key);
          }
        }
        if (rank < k) kept[rank] = key;
      }
    }
  }
  __syncthreads();
  const int n_kept = static_cast<int>(min(count, static_cast<long long>(k)));

  // 3. Row-major rank of each kept key, and the outputs at that slot.
  for (int r = tid; r < k; r += kMergeThreads) {
    size_t o = static_cast<size_t>(plane) * k + r;
    if (r >= n_kept) {
      coords[2 * o] = 0;
      coords[2 * o + 1] = 0;
      scores[o] = 0.0f;
      valid[o] = false;
      continue;
    }
    const Key key = kept[r];
    const Key order = row_major(key);
    int pos = 0;
    for (int q = 0; q < n_kept; ++q) pos += row_major(kept[q]) < order;
    o = static_cast<size_t>(plane) * k + pos;
    const float s = key_score(key);
    const int lin = key_lin(key);
    const bool ok = finite(s);
    coords[2 * o] = ok ? lin / up_w : 0;
    coords[2 * o + 1] = ok ? lin % up_w : 0;
    scores[o] = ok ? s : 0.0f;
    valid[o] = ok;
  }
  if (tid == 0) overflow[plane] = count > k;
}

}  // namespace

extern "C" {

// The tile, in source cells, and the upsampling factor.
void fused_peaks_shape(int* tile_src_rows, int* tile_src_cols, int* factor) {
  *tile_src_rows = kTileSrcRows;
  *tile_src_cols = kTileSrcCols;
  *factor = kFactor;
}

// The FIR taps, once per process: weights host (8, 4) float32, bases
// host (8,) int32, from ops/upsample.py::_phase_table, and their reach
// (ops/fused_peaks.py::tap_reach).
void fused_peaks_set_taps(const float* weights, const int* bases,
                          float reach) {
  for (int r = 0; r < kFactor; ++r) {
    for (int i = 0; i < 4; ++i) g_taps.w[r][i] = weights[r * 4 + i];
    g_taps.base[r] = bases[r];
  }
  g_taps.reach = reach;
  g_taps_set = true;
}

// heat: (n, h, w, C) float32 on the device, strides in elements; the
// planes are (image, channel) pairs for the first `parts` channels.
// tile_keys (n * parts, tiles, k) uint64, tile_counts (n * parts, tiles)
// int32. Returns cudaGetLastError() after the launch.
int fused_peaks_scan(const float* heat, long long s_b, long long s_h,
                     long long s_w, long long s_c, int n, int parts, int h,
                     int w, float threshold, int k, Key* tile_keys,
                     int* tile_counts, void* stream) {
  if (!g_taps_set || n < 1 || parts < 1 || h < 1 || w < 1 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + kTileSrcCols - 1) / kTileSrcCols;
  const int n_tiles = ((h + kTileSrcRows - 1) / kTileSrcRows) * tiles_x;
  const long long blocks = static_cast<long long>(n) * parts * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      heat, s_b, s_h, s_w, s_c, parts, h, w, tiles_x, n_tiles, threshold, k,
      g_taps, tile_keys, tile_counts);
  return static_cast<int>(cudaGetLastError());
}

// tile_keys and tile_counts as fused_peaks_scan wrote them for m planes;
// kept_keys (m, k) uint64 workspace. Writes coords (m, k, 2) int32,
// scores (m, k) float32, valid (m, k) bool, overflow (m,) bool. Returns
// cudaGetLastError() after the launch.
int fused_peaks_merge(const Key* tile_keys, const int* tile_counts, int m,
                      int n_tiles, int k, int up_w, Key* kept_keys,
                      int* coords, float* scores, bool* valid,
                      bool* overflow, void* stream) {
  if (m < 1 || n_tiles < 1 || k < 0 || up_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  merge_kernel<<<m, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_keys, tile_counts, n_tiles, k, up_w, kept_keys, coords, scores,
      valid, overflow);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
