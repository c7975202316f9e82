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
// One block per image. The block loads the image's K boxes and valid
// flags into dynamic shared memory, with each box's area and a
// `suppressed` flag, then walks i = 0 .. K-1. When candidate i is kept,
// the threads that own j > i (a strided loop over j, so any K runs with
// at most 1024 threads) test IoU(i, j) and set suppressed[j]; then one
// barrier. A step whose candidate is not kept writes nothing, and every
// thread reads the same flag, so such a step skips its barrier. Shared
// memory is 22 bytes a box: K = 4096 needs 90,112 bytes, above the 48 KB
// default, so the launch raises the kernel's limit first.
//
// What bounds it on an H100: neither bytes (17 bytes in and 1 out per
// box) nor operations (about 13 float32 operations per tested pair, at
// most K^2 / 2 pairs). The bound is the chain of K dependent steps: step
// i+1 cannot start before step i's writes are visible to the block, so
// the time is about (number of kept boxes) x (barrier latency + one
// strided IoU pass), on one SM per image. Making it fast is later work,
// e.g. IoU bitmask rows computed in parallel, then a single-warp sweep.
//
// Numerics: the IoU is iou_matrix's (terran_tpu/ops/nms.py:29-38) in the
// same operation order, written with __fsub_rn/__fmul_rn/__fadd_rn/
// __fdiv_rn so that no FMA contraction moves a value near the threshold:
// area = (x2 - x1) * (y2 - y1); wh = max(min(rb) - max(lt), 0) with NaN
// propagated as torch.maximum/minimum/clamp do; inter = w * h;
// union = (area_i + area_j) - inter; iou = union > 0 ? inter / union : 0,
// so a NaN or infinite box (exp overflow in the decode) gives IoU 0 as
// the plain version's where(union > 0, ...) does; the test is a strict
// `iou > threshold`.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return a < b ? b : a;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7fc00000);
  return b < a ? b : a;
}

// torch.clamp(x, min=0): NaN stays NaN.
__device__ __forceinline__ float clamp0(float x) {
  return (x != x) ? x : (x < 0.0f ? 0.0f : x);
}

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float threshold) {
  const float w = clamp0(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)));
  const float h = clamp0(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > threshold;
}

// boxes (n, k, 4) float32, valid (n, k) bool, keep (n, k) bool; one block
// per image.
__global__ void nms_kernel(const float* __restrict__ boxes,
                           const uint8_t* __restrict__ valid, int k,
                           float threshold, uint8_t* __restrict__ keep) {
  extern __shared__ float4 smem[];
  float4* s_box = smem;                                   // k x 16 bytes
  float* s_area = reinterpret_cast<float*>(s_box + k);    // k x 4
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_area + k);  // k x 1
  uint8_t* s_sup = s_valid + k;                           // k x 1

  const long long base = static_cast<long long>(blockIdx.x) * k;
  const float* b = boxes + base * 4;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float4 box = make_float4(b[4 * j], b[4 * j + 1], b[4 * j + 2],
                                   b[4 * j + 3]);
    s_box[j] = box;
    s_area[j] = area(box);
    s_valid[j] = valid[base + j];
    s_sup[j] = 0;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // Uniform across the block: every thread reads the same flags.
    if (s_sup[i] || !s_valid[i]) continue;
    const float4 box_i = s_box[i];
    const float area_i = s_area[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (!s_sup[j] &&
          overlaps(box_i, area_i, s_box[j], s_area[j], threshold)) {
        s_sup[j] = 1;
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    keep[base + j] = (!s_sup[j] && s_valid[j]) ? 1 : 0;
  }
}

// Dynamic shared memory for k boxes, in bytes.
int nms_shared_bytes(int k) { return k * (16 + 4 + 1 + 1); }

}  // namespace

extern "C" {

// boxes (n, k, 4) float32 contiguous, valid (n, k) bool contiguous, keep
// (n, k) bool, all on the device. Returns cudaGetLastError() after the
// launch, or the attribute call's error when k needs more shared memory
// than the device allows a block.
int nms_suppress(const float* boxes, const uint8_t* valid, int n, int k,
                 float threshold, uint8_t* keep, void* stream) {
  if (n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = nms_shared_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = ((k + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  nms_kernel<<<n, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      boxes, valid, k, threshold, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
