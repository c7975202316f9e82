// Greedy suppression over pre-selected boxes (fixed-K NMS), for sm_90a.
//
// Replaces terran_tpu/ops/nms.py:82-90, the jax.lax.fori_loop of
// nms_fixed, which XLA compiles to one device loop; that loop has no
// Pallas kernel. Eager PyTorch has no counterpart: the plain version runs
// K Python steps of a few launches each. Same function: for candidates in
// descending score order, candidate i survives iff it is valid and no
// earlier survivor overlaps it by IoU > threshold; a survivor suppresses
// every later candidate it overlaps.
//
// Two kernels, both on the caller's stream:
//
// mask_kernel: the IoU bitmask, in parallel over the card. Grid (column
// tile, row tile, image) of 64-candidate tiles; blocks below the diagonal
// return at once. A block stages its 64 column boxes and their areas in
// shared memory; four neighbouring lanes share row i = 64 * row + r, each
// testing 16 columns, and OR their parts by shuffles into one 64-bit
// word: bit b set iff j = 64 * col + b has j > i, j < K and IoU(i, j) >
// threshold. The mask is kept column-major, mask[col][i], so that a
// block's 64 words are one coalesced store and a chunk's rows of one
// column are 512 contiguous bytes for the sweep. Words left of a row's own
// tile are never written and never read. Bound by operations: about 13
// float32 operations per pair over K^2 / 2 pairs (an IEEE division only
// where the boxes intersect), against a few bytes a pair. 64-wide tiles
// give N * W * (W + 1) / 2 working blocks (W = ceil(K / 64); 1,088 at
// N = 8, K = 1024), so the work fills the card's 132 SMs instead of one
// SM per image; four lanes a row cut each thread's dependent run of tests
// to 16, and the column boxes are read from shared memory by broadcast.
//
// sweep_kernel: the greedy decision, one block per image, in K / 64 chunk
// steps. The `removed` words and the valid flags, packed by warp ballots
// before the walk, live in shared memory. For chunk c, alive = valid &
// ~removed[c]; a chunk with no alive candidate keeps nothing and is
// skipped. Otherwise one thread decides the chunk in order, in registers:
// each alive candidate not yet removed is kept and ORs in its row's
// diagonal word mask[c][i], whose bits are later candidates of the chunk,
// so each bit is final when the walk reaches it; no barrier sits inside
// this step. Then each warp owns later words w > c: lane l takes kept rows
// l and l + 32, and the warp ORs their mask[w][i] into removed[w] by
// __reduce_or_sync. cp.async copies chunk c + 1's rows (columns c + 1 ..
// W - 1, 16 bytes a thread) into the other half of a double buffer while
// chunk c is decided and swept, so the dependent chain reads only shared
// memory and registers. Bound by its chain: K / 64 chunk steps, each a
// barrier and, where the chunk has an alive candidate, 64 register bit
// steps, a second barrier and one OR pass; the IoU work and the
// device-memory reads stay off that chain. Shared memory is 1040 * W
// bytes: 66,560 at K = 4096, above the 48 KB default, so the launch
// raises the kernel's limit first.
//
// Numerics: the IoU is iou_matrix's (terran_tpu/ops/nms.py:29-38) in the
// same operation order, written with __fsub_rn/__fmul_rn/__fadd_rn/
// __fdiv_rn so that no FMA contraction moves a value near the threshold:
// area = (x2 - x1) * (y2 - y1); wh = max(min(rb) - max(lt), 0) with NaN
// propagated as torch.maximum/minimum/clamp do; inter = w * h;
// union = (area_i + area_j) - inter; iou = union > 0 ? inter / union : 0,
// so a NaN or infinite box (exp overflow in the decode) gives IoU 0 as
// the plain version's where(union > 0, ...) does; the test is a strict
// `iou > threshold`. The mask bits are therefore exactly the plain
// version's `ious > iou_threshold`.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;           // candidates per mask tile and chunk
constexpr int kSplit = 4;           // mask_kernel threads per row
constexpr int kMaskThreads = kTile * kSplit;
constexpr int kSweepThreads = 256;
// Dynamic shared memory a launch may take without raising the limit.
constexpr int kDefaultSharedBytes = 48 * 1024;

// max and min that return NaN when either input is NaN, as
// torch.maximum and torch.minimum do.
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.clamp(x, min=0): NaN stays NaN. (A zero's sign may differ from
// torch's; no comparison below can see it.)
__device__ __forceinline__ float clamp0(float x) { return nan_max(x, 0.0f); }

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float4 load_box(const float* b, int j) {
  return make_float4(b[4 * j], b[4 * j + 1], b[4 * j + 2], b[4 * j + 3]);
}

__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float threshold) {
  const float w = clamp0(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)));
  const float h = clamp0(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  // Divide only where inter and union are both positive: elsewhere the
  // plain version's IoU is 0 or a signed zero (a NaN inter makes the union
  // NaN), which every comparison takes as 0.
  const float iou =
      (inter > 0.0f && uni > 0.0f) ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > threshold;
}

// boxes (n, k, 4) float32 -> mask (n, words, 64 * words) 64-bit words,
// column-major; grid (words, words, n), kMaskThreads threads: kSplit
// neighbouring lanes share a row, each testing a quarter of the tile's
// columns.
__global__ void mask_kernel(const float* __restrict__ boxes, int k,
                            int words, float threshold,
                            uint64_t* __restrict__ mask) {
  const int row = blockIdx.y, col = blockIdx.x;
  if (col < row) return;  // uniform across the block
  __shared__ float4 s_box[kTile];
  __shared__ float s_area[kTile];

  const long long img = blockIdx.z;
  const float* b = boxes + img * k * 4;
  const int t = threadIdx.x;
  if (t < kTile && col * kTile + t < k) {
    const float4 box = load_box(b, col * kTile + t);
    s_box[t] = box;
    s_area[t] = area(box);
  }
  __syncthreads();

  const int r = t / kSplit;
  const int i = row * kTile + r;
  const int lo = (t % kSplit) * (kTile / kSplit);
  const int hi = min(lo + kTile / kSplit, k - col * kTile);
  uint64_t bits = 0;
  if (i < k) {
    const float4 box_i = load_box(b, i);
    const float area_i = area(box_i);
    for (int c = col == row ? max(lo, r + 1) : lo; c < hi; ++c) {
      if (overlaps(box_i, area_i, s_box[c], s_area[c], threshold)) {
        bits |= 1ull << c;
      }
    }
  }
  // OR the kSplit partial words of the row; its first lane writes them.
  for (int d = 1; d < kSplit; d <<= 1) {
    bits |= __shfl_xor_sync(0xffffffffu, bits, d);
  }
  if (i < k && t % kSplit == 0) {
    mask[(img * words + col) * words * kTile + i] = bits;
  }
}

// Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint64_t* dst,
                                           const uint64_t* src) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying chunk c's 64 rows (some past k when c is the last
// chunk; never read) of columns c .. words - 1 into s_rows, as they lie
// in the mask: column-major, 16 bytes a thread.
__device__ __forceinline__ void stage_rows(const uint64_t* mask, int words,
                                           int c, uint64_t* s_rows) {
  constexpr int kPieces = kTile / 2;  // 16-byte pieces of a column's rows
  for (int t = threadIdx.x; t < (words - c) * kPieces; t += blockDim.x) {
    const int w = c + t / kPieces;
    const int at = w * kTile + 2 * (t % kPieces);
    cp_async16(s_rows + at,
               mask + static_cast<long long>(w) * words * kTile +
                   c * kTile + 2 * (t % kPieces));
  }
}

// The greedy walk of one chunk: the candidates of `alive` in order, each
// kept unless an earlier kept one's diagonal word removed it. Starting
// from removed = ~alive, bit b of `removed` is final when b is reached,
// since diagonal[b] holds only bits above b. In 32-bit halves: the walk
// over bits 0-31 tests only the low half, and the rows of bits 32-63
// have no low half. The loads sit outside the selects, so they do not
// wait on the chain.
__device__ __forceinline__ uint64_t decide(uint64_t alive,
                                           const uint64_t* diagonal) {
  const uint2* halves = reinterpret_cast<const uint2*>(diagonal);
  uint32_t lo = ~static_cast<uint32_t>(alive);
  uint32_t hi = ~static_cast<uint32_t>(alive >> 32);
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint2 d = halves[b];
    const bool kept = !((lo >> b) & 1);
    lo |= kept ? d.x : 0u;
    hi |= kept ? d.y : 0u;
  }
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const uint32_t d = halves[32 + b].y;
    hi |= ((hi >> b) & 1) ? 0u : d;
  }
  return ~((static_cast<uint64_t>(hi) << 32) | lo);
}

// mask from mask_kernel and valid (n, k) bool -> keep (n, k) bool; one
// block of whole warps per image.
__global__ void sweep_kernel(const uint64_t* __restrict__ mask,
                             const uint8_t* __restrict__ valid, int k,
                             int words, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) uint64_t smem[];
  uint64_t* s_removed = smem;             // words
  uint64_t* s_valid = s_removed + words;  // words
  uint64_t* s_rows = s_valid + words;     // 2 x words x kTile
  __shared__ uint64_t s_kept;

  const long long img = blockIdx.x;
  const uint64_t* m = mask + img * words * words * kTile;
  const uint8_t* v = valid + img * k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  stage_rows(m, words, 0, s_rows);
  cp_async_commit();
  for (int w = threadIdx.x; w < words; w += blockDim.x) s_removed[w] = 0;
  // The valid flags, 32 a warp ballot; 0 past k.
  for (int base = 32 * warp; base < words * kTile; base += 32 * warps) {
    const int i = base + lane;
    const unsigned bits = __ballot_sync(0xffffffffu, i < k && v[i]);
    if (lane == 0) reinterpret_cast<uint32_t*>(s_valid)[base / 32] = bits;
  }

  for (int c = 0; c < words; ++c) {
    // Chunk c's rows are in, the previous chunk's ORs are in removed, and
    // its rows buffer is free for chunk c + 1.
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < words) {
      stage_rows(m, words, c + 1, s_rows + ((c + 1) & 1) * words * kTile);
      cp_async_commit();
    }
    const uint64_t alive = s_valid[c] & ~s_removed[c];
    uint64_t kept = 0;
    if (alive) {  // uniform: read from shared memory after the barrier
      const uint64_t* rows = s_rows + (c & 1) * words * kTile;
      if (threadIdx.x == 0) s_kept = decide(alive, rows + c * kTile);
      __syncthreads();
      kept = s_kept;
      for (int w = c + 1 + warp; w < words; w += warps) {
        uint64_t x = 0;
        if ((kept >> lane) & 1) x = rows[w * kTile + lane];
        if ((kept >> (lane + 32)) & 1) x |= rows[w * kTile + lane + 32];
        const unsigned lo = __reduce_or_sync(0xffffffffu,
                                             static_cast<unsigned>(x));
        const unsigned hi = __reduce_or_sync(
            0xffffffffu, static_cast<unsigned>(x >> 32));
        if (lane == 0) {
          s_removed[w] |= (static_cast<uint64_t>(hi) << 32) | lo;
        }
      }
    }
    const int i = c * kTile + threadIdx.x;
    if (threadIdx.x < kTile && i < k) {
      keep[img * k + i] = static_cast<uint8_t>((kept >> threadIdx.x) & 1);
    }
  }
}

int words_for(int k) { return (k + kTile - 1) / kTile; }

// Shared memory of sweep_kernel, in bytes.
int sweep_bytes(int words) {
  return (2 + 2 * kTile) * words * 8;
}

int launch_mask(const float* boxes, int n, int k, float threshold,
                uint64_t* mask, cudaStream_t stream) {
  const int words = words_for(k);
  mask_kernel<<<dim3(words, words, n), kMaskThreads, 0, stream>>>(
      boxes, k, words, threshold, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Every pointer is to contiguous device memory: boxes (n, k, 4) float32,
// valid and keep (n, k) bool, mask (n, W, 64 W) 64-bit words, column-major,
// W = ceil(k / 64), 16-byte aligned. Each returns the first nonzero
// cudaGetLastError() after a launch, or the attribute call's error when k
// needs more shared memory than the device allows a block.

// The mask kernel alone.
int nms_mask(const float* boxes, int n, int k, float threshold,
             uint64_t* mask, void* stream) {
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mask(boxes, n, k, threshold, mask,
                     static_cast<cudaStream_t>(stream));
}

// The mask kernel, then the sweep kernel.
int nms_suppress(const float* boxes, const uint8_t* valid, int n, int k,
                 float threshold, uint64_t* mask, uint8_t* keep,
                 void* stream) {
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = words_for(k);
  const int bytes = sweep_bytes(words);
  if (bytes > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rc = launch_mask(boxes, n, k, threshold, mask, s);
  if (rc != 0) return rc;
  sweep_kernel<<<n, kSweepThreads, bytes, s>>>(mask, valid, k, words, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
