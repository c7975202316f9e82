// The passes around torch._int_mm in the int8 conv (models/quant.py), for
// sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves its int8 conv
// (terran_tpu/models/quant.py::quant_conv) to XLA, which fuses the
// activation's scale, its rounding and the dequantisation around the
// product. Eager PyTorch has no int8 conv on CUDA. The port runs each
// conv as an int8 im2col matrix times the int8 weight matrix in
// torch._int_mm, and the passes around that product took some 17 eager
// launches a conv: abs, amax, the scale, a float32 cast, the division,
// round and clamp, a zeroed pad buffer and two copies, then the
// dequantisation and its module's bias or affine through float64
// temporaries. Here they are three kernels, each on the caller's stream:
//
// absmax_kernel: max|x| of the NHWC activation (float32 or bf16) into a
// float32 scalar that the launcher first zeroes with one memset. Each
// thread reads 16 bytes at a time where the activation is 16-byte aligned,
// and keeps the largest |x| as its float32 bits: for non-negative floats
// the unsigned order of the bits is the order of the values, and every
// NaN lies above infinity, so the result is x.abs().amax() exactly, a NaN
// where the activation holds one. A warp and then a block reduce the
// bits; one atomicMax a block combines them. Max is order-free, so the
// value does not depend on the blocks' order.
//
// quantize_im2col_kernel: reads the activation and max|x|, computes the
// scale xs = max(max|x| * float32(1 / 127), 1e-12) in float32 as
// quantize_activation does (a NaN stays NaN), writes it for the caller,
// and writes clamp(rint(x / xs), -127, 127) as int8 straight into the
// (rows, K_pad) column matrix of torch._int_mm: row (b, oy, ox), column
// (kh, kw, cin). It writes every byte of the matrix: spatial padding, the
// K_pad - K columns and the rows past M (at most 16, for _int_mm's 17
// rows) are zeros, so the buffer needs no zero fill and no padded copy.
// The matrix holds kh * kw bytes for each input element, so quantising
// each of them where it is written would divide kh * kw times an element
// (49 for OpenPose's 7x7 convs). Instead a block takes a tile of output
// pixels of one image, quantises the input window the tile reads once
// into shared memory (zeros outside the image), and then copies the
// tile's rows out of it: 16 bytes of a row a thread, read from shared
// memory with one 16-byte load where cin is a multiple of 16 (one tap's
// channels), byte by byte otherwise (cin = 3 in FaceResNet100's first
// conv, 185 in OpenPose's refinement stages). The tile, at most 8 x 16
// pixels, is cut down until its window fits 40 KB and the grid has two
// blocks an SM, so that the deep 7x7 convs over 23 x 41 still fill the
// card; a window is read 1.4-4.4 times over, against 9-49 times.
//
// The rounding is the eager x / xs in IEEE round-to-nearest: an
// approximate reciprocal would change int8 values. The kernel first takes
// q = x * fl(1 / xs). Since |x| <= max|x|, |x / xs| <= 127 (1 + 2^-23),
// and q lies within 1.5 * 2^-23 * 127.01 < 2^-15 of the rounded quotient
// fl(x / xs); where q is farther than 2^-15 from every half-integer, both
// round to the same integer. Otherwise (a near-tie, or a NaN) the kernel
// divides (__fdiv_rn) and rounds that, as the eager path does. The
// difference q - rint(q) is exact, so the test is. Against a division of
// every element, the product takes about 11% off the kernel's time at the
// pipeline's shapes on an H100, with the same bytes out.
//
// dequant_epilogue_kernel: reads the padded (rows, N_pad) int32 product
// and writes the (M, N) result, NHWC, in the compute dtype, in one of
// three modes, one a caller, each with the roundings of the eager
// composition it replaces, in their order:
//   kDequantize (quant_conv, the task APIs): float(acc) * (xs * scale[c])
//     in float32, then the cast;
//   kBias (OpenPose's conv + bias [+ ReLU]): (double)bias64[c] +
//     (double)float(acc) * (double)(xs * scale[c]), one rounding to
//     float32 (the product of two floats is exact in float64), then the
//     ReLU (NaN kept, as torch.clamp_min keeps it), then the cast;
//   kAffine (ArcFace's conv + folded BatchNorm): the kDequantize value in
//     the compute dtype, then bias64[c] + value * scale64[c] in float64
//     (exact product, one rounding), then to the compute dtype as PyTorch
//     converts float64: to float32, then to bf16.
// Where N is a multiple of 8 (every conv but OpenPose's 38- and
// 19-channel outputs) a thread reads 32 bytes and writes 8 channels, and
// keeps its channels' scales, biases and affine scales in registers.
//
// What bounds the three: bytes. At the pipeline's shapes (64 crops of
// FaceResNet100, 8 OpenPose frames at 184 x 327) they read the activation
// about twice, write the int8 column matrix once (8.0 GB a batch) and read
// the int32 product and write the output once: ~16 GB a batch, ~5 ms at
// 3.35 TB/s. The product itself stays in torch._int_mm (cuBLASLt), a
// library call as XLA's int8 conv is.
//
// Conversions as PyTorch's CUDA kernels make them: int32 -> float32 and
// float64 -> float32 round to nearest (__int2float_rn, __double2float_rn),
// float32 -> bf16 by __float2bfloat16 (c10::BFloat16's constructor on
// sm_80 and above), float32 -> int8 by static_cast. Arithmetic is written
// with __fmul_rn, __fdiv_rn, __dmul_rn and __dadd_rn so that no FMA
// contraction merges two roundings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// absmax_kernel's blocks an SM: its 2,048 threads.
constexpr int kAbsmaxBlocksPerSm = 2048 / kThreads;
// quantize_im2col_kernel: the largest tile, the shared memory its input
// window may take, and the blocks an SM the tile is cut down for.
constexpr int kTileRows = 8;
constexpr int kTileCols = 16;
constexpr int kWindowBytes = 40 * 1024;
constexpr int kTileBlocksPerSm = 2;
// Distance from a half-integer within which q = x * fl(1 / xs) may round
// otherwise than fl(x / xs): 2^-15.
constexpr float kTieMargin = 0.5f - 1.0f / 32768.0f;
// dequant_epilogue_kernel: output groups a block, about.
constexpr int kGroupsPerBlock = 2048;

// Element types of the activation and the output (models/quant.py).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// The epilogue's modes (models/quant.py: DEQUANTIZE, BIAS, AFFINE).
constexpr int kDequantize = 0;
constexpr int kBias = 1;
constexpr int kAffine = 2;

// One quantised conv: NHWC input, square kernel, its output and the
// column matrix's shape.
struct ConvShape {
  int n, h, w, c;
  int k, stride, pad;
  int ho, wo;
  int m;     // n * ho * wo output rows
  int rows;  // rows of the column matrix, max(m, 17)
  int kdim;  // k * k * c
  int kpad;  // kdim rounded up to a multiple of 8
};

// A block's output tile: th x tw pixels, and the input window of ih x iw
// pixels it reads; tiles_y x tiles_x tiles an image.
struct Tile {
  int th, tw, ih, iw, tiles_y, tiles_x;
};

// float32 of an element: float32 as it is; bf16, held as its 16 bits,
// widened exactly.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// A float32 value in the output type.
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ uint16_t narrow<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// The bits of |v|.
__device__ __forceinline__ uint32_t abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_kernel(const T* __restrict__ x, long long n, bool vectorized,
                  uint32_t* __restrict__ max_bits) {
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t m = 0;
  long long head = 0;
  if (vectorized) {
    const long long vecs = n / kVec;
    const uint4* src = reinterpret_cast<const uint4*>(x);
    for (long long v = tid; v < vecs; v += stride) {
      const uint4 raw = src[v];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) m = max(m, abs_bits(widen(e[i])));
    }
    head = vecs * kVec;
  }
  for (long long i = head + tid; i < n; i += stride) {
    m = max(m, abs_bits(widen(x[i])));
  }
  __shared__ uint32_t warp_max[kWarps];
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kWarps ? warp_max[threadIdx.x] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (threadIdx.x == 0) atomicMax(max_bits, m);
  }
}

// quantize_activation's xs: max(max_abs * reciprocal, floor), a NaN kept
// as torch.clamp keeps it.
__device__ __forceinline__ float activation_scale(float max_abs,
                                                  float reciprocal,
                                                  float floor) {
  const float xs = __fmul_rn(max_abs, reciprocal);
  return isnan(xs) ? xs : fmaxf(xs, floor);
}

// clamp(rint(v / xs), -127, 127) as an int8 byte; inv = fl(1 / xs) (see
// the note at the top). A NaN goes through the same cast as PyTorch's
// float32 -> int8 copy.
__device__ __forceinline__ uint32_t quantize(float v, float xs, float inv) {
  const float q = __fmul_rn(v, inv);
  float r = rintf(q);
  if (!(fabsf(__fsub_rn(q, r)) < kTieMargin)) r = rintf(__fdiv_rn(v, xs));
  if (!isnan(r)) r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<uint8_t>(static_cast<int8_t>(r));
}

// kChunk bytes of the column matrix a thread in the copy-out, packed
// little-endian into 32-bit words. kVector: cin % 16 == 0, so a chunk is
// 16 channels of one tap. Dynamic shared memory: the quantised window
// (ih x iw x c bytes, rounded up to 16), then one int a chunk (kVector:
// the chunk's offset in a pixel's window) or a tap (the tap's offset).
template <typename T, int kChunk, bool kVector>
__global__ void __launch_bounds__(kThreads) quantize_im2col_kernel(
    const T* __restrict__ x, ConvShape s, Tile tile, bool vector_load,
    const uint32_t* __restrict__ max_bits, float reciprocal, float floor,
    float* __restrict__ xs_out, int8_t* __restrict__ cols) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kVecIn = 16 / sizeof(T);  // elements of a 16-byte load
  const int window = tile.ih * tile.iw * s.c;
  int* offsets = reinterpret_cast<int*>(smem + ((window + 15) & ~15));
  const float xs =
      activation_scale(__uint_as_float(*max_bits), reciprocal, floor);
  const float inv = __frcp_rn(xs);
  if (blockIdx.x == 0 && threadIdx.x == 0) *xs_out = xs;
  int rest = blockIdx.x;
  const int tx = rest % tile.tiles_x;
  rest /= tile.tiles_x;
  const int ty = rest % tile.tiles_y;
  const int b = rest / tile.tiles_y;
  const int oy0 = ty * tile.th, ox0 = tx * tile.tw;
  const int y0 = oy0 * s.stride - s.pad, x0 = ox0 * s.stride - s.pad;

  // 1. The window, quantised once, zeros outside the image.
  const size_t image = static_cast<size_t>(b) * s.h;
  if (vector_load) {
    const int groups = s.c / kVecIn;
    for (int t = threadIdx.x; t < tile.ih * tile.iw * groups; t += kThreads) {
      const int pixel = t / groups;
      const int ci = (t - pixel * groups) * kVecIn;
      const int iy = pixel / tile.iw, ix = pixel - iy * tile.iw;
      const int y = y0 + iy, xx = x0 + ix;
      uint32_t words[kVecIn / 4];
#pragma unroll
      for (int i = 0; i < kVecIn / 4; ++i) words[i] = 0;
      if (y >= 0 && y < s.h && xx >= 0 && xx < s.w) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            x + ((image + y) * s.w + xx) * s.c + ci);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < kVecIn; ++i) {
          words[i / 4] |= quantize(widen(e[i]), xs, inv) << (8 * (i % 4));
        }
      }
      uint8_t* dst = smem + pixel * s.c + ci;
      if (kVecIn == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = words[0];
      }
    }
  } else {
    for (int t = threadIdx.x; t < window; t += kThreads) {
      const int pixel = t / s.c;
      const int iy = pixel / tile.iw, ix = pixel - iy * tile.iw;
      const int y = y0 + iy, xx = x0 + ix;
      uint32_t q = 0;
      if (y >= 0 && y < s.h && xx >= 0 && xx < s.w) {
        q = quantize(
            widen(x[((image + y) * s.w + xx) * s.c + (t - pixel * s.c)]), xs,
            inv);
      }
      smem[t] = static_cast<uint8_t>(q);
    }
  }
  const int chunks = s.kpad / kChunk;
  if (kVector) {
    for (int t = threadIdx.x; t < chunks; t += kThreads) {
      const int col = t * kChunk, tap = col / s.c, ky = tap / s.k;
      offsets[t] = (ky * tile.iw + tap - ky * s.k) * s.c + col - tap * s.c;
    }
  } else {
    for (int t = threadIdx.x; t < s.k * s.k; t += kThreads) {
      const int ky = t / s.k;
      offsets[t] = (ky * tile.iw + t - ky * s.k) * s.c;
    }
  }
  __syncthreads();

  // 2. The tile's rows of the column matrix.
  for (int t = threadIdx.x; t < tile.th * tile.tw * chunks; t += kThreads) {
    const int pixel = t / chunks, chunk = t - pixel * chunks;
    const int py = pixel / tile.tw, px = pixel - py * tile.tw;
    const int oy = oy0 + py, ox = ox0 + px;
    if (oy >= s.ho || ox >= s.wo) continue;
    const uint8_t* src =
        smem + (py * s.stride * tile.iw + px * s.stride) * s.c;
    int8_t* dst = cols + ((static_cast<size_t>(b) * s.ho + oy) * s.wo + ox) *
                             s.kpad +
                  chunk * kChunk;
    if (kVector) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(src + offsets[chunk]);
      continue;
    }
    uint32_t words[kChunk / 4];
#pragma unroll
    for (int i = 0; i < kChunk / 4; ++i) words[i] = 0;
    const int col0 = chunk * kChunk;
    int tap = col0 / s.c;
    int ci = col0 - tap * s.c;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (col0 + i < s.kdim) {
        words[i / 4] |= static_cast<uint32_t>(src[offsets[tap] + ci])
                        << (8 * (i % 4));
        if (++ci == s.c) {
          ci = 0;
          ++tap;
        }
      }
    }
    if (kChunk == 16) {
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(words[0], words[1]);
    }
  }

  // 3. The rows past M (only where M < 17): zeros.
  if (blockIdx.x == 0) {
    const size_t end = static_cast<size_t>(s.rows) * s.kpad;
    for (size_t i = static_cast<size_t>(s.m) * s.kpad + threadIdx.x; i < end;
         i += kThreads) {
      cols[i] = 0;
    }
  }
}

// One output element of the epilogue in the output type T, from its
// channel's s = xs * scale[c] and, in kBias and kAffine, its float64 bias
// and (kAffine) scale.
template <int kMode, typename T>
__device__ __forceinline__ T finish(int32_t acc, float s, double bias,
                                    double scale64, bool relu) {
  const float a = __int2float_rn(acc);
  if (kMode == kBias) {
    float y = __double2float_rn(__dadd_rn(
        bias, __dmul_rn(static_cast<double>(a), static_cast<double>(s))));
    if (relu && !isnan(y)) y = fmaxf(y, 0.0f);
    return narrow<T>(y);
  }
  const T v = narrow<T>(__fmul_rn(a, s));
  if (kMode == kDequantize) return v;
  return narrow<T>(__double2float_rn(
      __dadd_rn(bias, __dmul_rn(static_cast<double>(widen(v)), scale64))));
}

// A thread's kVec channels from c0: s = xs * scale[c], the bias and the
// affine scale, in registers.
template <int kVec, int kMode>
struct Channels {
  float s[kVec];
  double bias[kVec], scale64[kVec];

  __device__ __forceinline__ void load(int c0, float xs,
                                       const float* __restrict__ scale,
                                       const double* __restrict__ bias64,
                                       const double* __restrict__ affine) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      s[i] = __fmul_rn(xs, scale[c0 + i]);
      bias[i] = kMode == kDequantize ? 0.0 : bias64[c0 + i];
      scale64[i] = kMode == kAffine ? affine[c0 + i] : 0.0;
    }
  }
};

// kVec channels a thread: 8 where N is a multiple of 8 (then N_pad = N),
// else 1. Where kThreads is a multiple of the N / kVec groups of a row, a
// thread's items all share its channels, loaded once.
template <typename T, int kVec, int kMode>
__global__ void __launch_bounds__(kThreads) dequant_epilogue_kernel(
    const int32_t* __restrict__ acc, int m, int npad, int out_ch,
    int rows_per_block, const float* __restrict__ xs_in,
    const float* __restrict__ scale, const double* __restrict__ bias64,
    const double* __restrict__ scale64, bool relu, T* __restrict__ out) {
  const float xs = *xs_in;
  const int groups = out_ch / kVec;
  const int row0 = blockIdx.x * rows_per_block;
  const int items = min(rows_per_block, m - row0) * groups;
  const bool fixed = kThreads % groups == 0;
  Channels<kVec, kMode> ch;
  if (fixed) {
    ch.load(threadIdx.x % groups * kVec, xs, scale, bias64, scale64);
  }
  for (int t = threadIdx.x; t < items; t += kThreads) {
    const int row = row0 + t / groups;
    const int c0 = (t % groups) * kVec;
    if (!fixed) ch.load(c0, xs, scale, bias64, scale64);
    const int32_t* src = acc + static_cast<size_t>(row) * npad + c0;
    T* dst = out + static_cast<size_t>(row) * out_ch + c0;
    if (kVec == 1) {
      *dst = finish<kMode, T>(*src, ch.s[0], ch.bias[0], ch.scale64[0], relu);
      continue;
    }
    int4 raw[2];
    raw[0] = reinterpret_cast<const int4*>(src)[0];
    raw[1] = reinterpret_cast<const int4*>(src)[1];
    const int32_t* a = reinterpret_cast<const int32_t*>(raw);
    alignas(16) T v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = finish<kMode, T>(a[i], ch.s[i], ch.bias[i], ch.scale64[i], relu);
    }
    const uint4* packed = reinterpret_cast<const uint4*>(v);
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(v) / 16); ++i) {
      reinterpret_cast<uint4*>(dst)[i] = packed[i];
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (count <= 0) count = 1;
  }
  return count;
}

template <typename T>
int launch_absmax(const T* x, long long n, uint32_t* max_bits,
                  cudaStream_t stream) {
  const cudaError_t err =
      cudaMemsetAsync(max_bits, 0, sizeof(uint32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vectorized = aligned16(x);
  constexpr long long kVec = 16 / sizeof(T);
  const long long work = vectorized ? (n + kVec - 1) / kVec : n;
  const long long wanted = (work + kThreads - 1) / kThreads;
  const long long most =
      static_cast<long long>(sm_count()) * kAbsmaxBlocksPerSm;
  const int blocks =
      static_cast<int>(wanted < 1 ? 1 : (wanted < most ? wanted : most));
  absmax_kernel<T><<<blocks, kThreads, 0, stream>>>(x, n, vectorized,
                                                     max_bits);
  return static_cast<int>(cudaGetLastError());
}

// The tile of a conv: at most kTileRows x kTileCols output pixels, cut
// down (the longer side first) until the window fits kWindowBytes and the
// grid has kTileBlocksPerSm blocks an SM.
Tile choose_tile(const ConvShape& s) {
  Tile t{};
  t.th = s.ho < kTileRows ? s.ho : kTileRows;
  t.tw = s.wo < kTileCols ? s.wo : kTileCols;
  auto window = [&](int th, int tw) {
    return static_cast<long long>((th - 1) * s.stride + s.k) *
           ((tw - 1) * s.stride + s.k) * s.c;
  };
  auto blocks = [&](int th, int tw) {
    return static_cast<long long>(s.n) * ceil_div(s.ho, th) *
           ceil_div(s.wo, tw);
  };
  auto halve = [&]() {
    if (t.tw >= t.th && t.tw > 1) {
      t.tw = (t.tw + 1) / 2;
    } else if (t.th > 1) {
      t.th = (t.th + 1) / 2;
    } else {
      return false;
    }
    return true;
  };
  while (window(t.th, t.tw) > kWindowBytes && halve()) {
  }
  while (blocks(t.th, t.tw) <
             static_cast<long long>(kTileBlocksPerSm) * sm_count() &&
         halve()) {
  }
  t.ih = (t.th - 1) * s.stride + s.k;
  t.iw = (t.tw - 1) * s.stride + s.k;
  t.tiles_y = ceil_div(s.ho, t.th);
  t.tiles_x = ceil_div(s.wo, t.tw);
  return t;
}

template <typename T>
int launch_im2col(const T* x, const ConvShape& s, const uint32_t* max_bits,
                  float reciprocal, float floor, float* xs, int8_t* cols,
                  cudaStream_t stream) {
  const Tile tile = choose_tile(s);
  const bool vector = s.c % 16 == 0;
  const int chunk = (vector || s.kpad % 16 == 0) ? 16 : 8;
  const bool vector_load = s.c % (16 / sizeof(T)) == 0 && aligned16(x);
  const long long window = static_cast<long long>(tile.ih) * tile.iw * s.c;
  const long long bytes =
      ((window + 15) & ~15LL) +
      4LL * (vector ? s.kpad / chunk : s.k * s.k);
  const long long blocks =
      static_cast<long long>(s.n) * tile.tiles_y * tile.tiles_x;
  if (bytes > 48 * 1024 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int shared = static_cast<int>(bytes);
  const int grid = static_cast<int>(blocks);
  if (vector) {
    quantize_im2col_kernel<T, 16, true><<<grid, kThreads, shared, stream>>>(
        x, s, tile, vector_load, max_bits, reciprocal, floor, xs, cols);
  } else if (chunk == 16) {
    quantize_im2col_kernel<T, 16, false><<<grid, kThreads, shared, stream>>>(
        x, s, tile, vector_load, max_bits, reciprocal, floor, xs, cols);
  } else {
    quantize_im2col_kernel<T, 8, false><<<grid, kThreads, shared, stream>>>(
        x, s, tile, vector_load, max_bits, reciprocal, floor, xs, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode>
int launch_epilogue_mode(const int32_t* acc, int m, int npad, int out_ch,
                         const float* xs, const float* scale,
                         const double* bias64, const double* scale64,
                         bool relu, T* out, cudaStream_t stream) {
  const bool vector = out_ch % 8 == 0 && npad == out_ch && aligned16(acc) &&
                      aligned16(out);
  const int groups = vector ? out_ch / 8 : out_ch;
  const int rows_per_block =
      kGroupsPerBlock / groups > 1 ? kGroupsPerBlock / groups : 1;
  const int blocks = ceil_div(m, rows_per_block);
  if (vector) {
    dequant_epilogue_kernel<T, 8, kMode><<<blocks, kThreads, 0, stream>>>(
        acc, m, npad, out_ch, rows_per_block, xs, scale, bias64, scale64,
        relu, out);
  } else {
    dequant_epilogue_kernel<T, 1, kMode><<<blocks, kThreads, 0, stream>>>(
        acc, m, npad, out_ch, rows_per_block, xs, scale, bias64, scale64,
        relu, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_epilogue(const int32_t* acc, int m, int npad, int out_ch,
                    int mode, bool relu, const float* xs, const float* scale,
                    const double* bias64, const double* scale64, T* out,
                    cudaStream_t stream) {
  switch (mode) {
    case kDequantize:
      return launch_epilogue_mode<T, kDequantize>(
          acc, m, npad, out_ch, xs, scale, bias64, scale64, relu, out,
          stream);
    case kBias:
      return launch_epilogue_mode<T, kBias>(acc, m, npad, out_ch, xs, scale,
                                            bias64, scale64, relu, out,
                                            stream);
    case kAffine:
      return launch_epilogue_mode<T, kAffine>(acc, m, npad, out_ch, xs,
                                              scale, bias64, scale64, relu,
                                              out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Every pointer is to contiguous device memory on the current device;
// `dtype` is kFloat32 or kBFloat16. Each returns the first nonzero CUDA
// error of its calls (cudaErrorInvalidValue for arguments no kernel
// takes), or 0.

// Zeroes max_abs (one float32), then absmax_kernel over the n elements of
// x: max_abs = max|x|.
int quant_conv_absmax(const void* x, long long n, int dtype, float* max_abs,
                      void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* bits = reinterpret_cast<uint32_t*>(max_abs);
  if (dtype == kFloat32) {
    return launch_absmax(static_cast<const float*>(x), n, bits, s);
  }
  if (dtype == kBFloat16) {
    return launch_absmax(static_cast<const uint16_t*>(x), n, bits, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// quantize_im2col_kernel, after quant_conv_absmax where with_absmax is
// set: x (n, h, w, c) NHWC, the conv's kernel, stride and padding, its
// output (ho, wo), the column matrix's rows (max(n * ho * wo, 17)) and
// kpad (k * k * c rounded up to 8); reads max_abs, writes xs (one
// float32) and every byte of cols (rows, kpad) int8, 16-byte aligned.
int quant_conv_im2col(const void* x, int dtype, int n, int h, int w, int c,
                      int k, int stride, int pad, int ho, int wo, int rows,
                      int kpad, int with_absmax, float* max_abs,
                      float reciprocal, float floor, float* xs, int8_t* cols,
                      void* stream) {
  const ConvShape s{n,  h,  w,  c, k, stride, pad, ho, wo, n * ho * wo, rows,
                    k * k * c, kpad};
  if (n < 1 || c < 1 || k < 1 || stride < 1 || ho < 1 || wo < 1 ||
      rows < s.m || kpad < s.kdim || kpad % 8 != 0 || !aligned16(cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (with_absmax) {
    const int err = quant_conv_absmax(
        x, static_cast<long long>(n) * h * w * c, dtype, max_abs, stream);
    if (err != 0) return err;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(max_abs);
  if (dtype == kFloat32) {
    return launch_im2col(static_cast<const float*>(x), s, bits, reciprocal,
                         floor, xs, cols, st);
  }
  if (dtype == kBFloat16) {
    return launch_im2col(static_cast<const uint16_t*>(x), s, bits,
                         reciprocal, floor, xs, cols, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dequant_epilogue_kernel: acc (>= m, npad) int32 -> out (m, out_ch) in
// out_dtype; scale (out_ch) float32; bias64 (out_ch) float64 in the kBias
// and kAffine modes, scale64 (out_ch) float64 in kAffine; relu only in
// kBias.
int quant_conv_epilogue(const int32_t* acc, int m, int npad, int out_ch,
                        int mode, int relu, const float* xs,
                        const float* scale, const double* bias64,
                        const double* scale64, void* out, int out_dtype,
                        void* stream) {
  if (m < 1 || out_ch < 1 || npad < out_ch ||
      (mode != kDequantize && bias64 == nullptr) ||
      (mode == kAffine && scale64 == nullptr) ||
      (relu && mode != kBias)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == kFloat32) {
    return launch_epilogue(acc, m, npad, out_ch, mode, relu != 0, xs, scale,
                           bias64, scale64, static_cast<float*>(out), s);
  }
  if (out_dtype == kBFloat16) {
    return launch_epilogue(acc, m, npad, out_ch, mode, relu != 0, xs, scale,
                           bias64, scale64, static_cast<uint16_t*>(out), s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
