// The epilogue of a floating-point conv (ops/conv_epilogue.py), for
// sm_90a: the per-channel bias or folded-BatchNorm affine, the activation
// and the residual add in one pass over the conv's output.
//
// Replaces no Pallas kernel: the JAX package leaves these element-wise
// ops to XLA, which fuses them into the convolution's output. Eager
// PyTorch runs each as a launch of its own, 2 to 6 a conv (a multiply, an
// add, a ReLU or a three-op PReLU, the residual add), and each reads and
// writes the whole activation. The trunks run NCHW over a permuted NHWC
// input, so the conv outputs are channels-last, and every per-channel
// (1, C, 1, 1) operand sends those launches to PyTorch's generic,
// index-computing element-wise kernel.
//
// One launch (group_kernel or strided_kernel) reads each element of x
// once (and of the residual, where there is one), and writes each once, in
// place where out == x:
//   v = float(x)
//   v = v * scale[c]                    where there is a scale
//   v = v + bias[c]                     where there is a bias
//   v = isnan(v) ? v : max(v, 0)        ReLU (torch.relu's clamp_min)
//   v = v >= 0 ? v : v * alpha[c]       or PReLU (the JAX models' where)
//   v = v + float(residual)             where there is a residual
//   out = v in the output type, rounded once to nearest even.
// The per-channel vectors are read as stored (the element type) and
// widened exactly. Every operation is a float32 one written with __fmul_rn
// and __fadd_rn, so that no FMA contraction merges two roundings, in the
// order of conv_epilogue_plain's PyTorch ops: the kernel equals it bit for
// bit. NaN and -0 go through each step as through those ops.
//
// What bounds it: bytes. At the pipeline's shapes the conv outputs of a
// batch (RetinaFace over 8 frames at 416 x 739, FaceResNet100 over 64
// crops, OpenPose over 8 frames at 184 x 327) are read and written once,
// plus FaceResNet100's residuals read once; at 3.35 TB/s that is the
// kernel's least time (chip_smoke.py prints it beside the measured one).
// The design spends nothing but those bytes:
//   - 16-byte loads and stores (8 bf16 or 4 float32 values) of
//     consecutive channels in group_kernel: channels-last with C a
//     multiple of the vector, which is every conv output of the models
//     but the odd ones. The block's
//     threads are a multiple of C / vector, so a thread's channels never
//     change and it loads their parameters once, as one 16-byte load each,
//     into registers where they stay packed; each step issues up to four
//     vectors' loads (and their residuals') before it computes any, up to
//     128 bytes in flight a thread. Any other layout (contiguous NCHW, which
//     no model's conv produces, and an odd channel count, 19, 26, 38, 52,
//     channels-last) takes strided_kernel, one element at a time, which
//     finds a thread's channel by one division when it starts and then
//     carries it from step to step.
//   - A grid-stride loop over a grid that fills every SM at the kernel's
//     occupancy where there is work for it, and gives each vector a thread
//     where there is less.
//
// Conversions as PyTorch's CUDA kernels make them: bf16 -> float32 exact,
// float32 -> bf16 by __float2bfloat16 (c10::BFloat16's constructor on
// sm_80 and above).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Element types (ops/conv_epilogue.py: _DTYPE_CODES).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Activations (ops/conv_epilogue.py: NONE, RELU, PRELU).
constexpr int kNone = 0;
constexpr int kRelu = 1;
constexpr int kPrelu = 2;

// group_kernel: vectors a thread loads before it computes, and the
// blocks an SM its registers are held to.
constexpr int kUnroll = 4;
constexpr int kGroupBlocksPerSm = 4;

// One epilogue: element i of x lies in channel (i / inner) % channels;
// inner is 1 channels-last and H * W for contiguous NCHW. A null pointer
// is an absent operand.
struct Args {
  const void* x;
  void* out;
  const void* residual;
  const void* scale;
  const void* bias;
  const void* alpha;
  long long n;
  long long inner;
  int channels;
  int act;
};

// kVec elements of type T (float, or bf16 held as its 16 bits): one
// element, or 16 bytes held as four 32-bit words, so that every element
// stays in a register. get widens element k to float32 exactly; put
// stores a float32 value into it in the element type, as PyTorch's CUDA
// kernels convert (__float2bfloat16, round to nearest even).
template <typename T, int kVec>
struct Vec {
  uint32_t w[kVec == 1 ? 1 : 4];

  static __device__ __forceinline__ Vec load(const void* p, long long i) {
    Vec x;
    if constexpr (kVec == 1) {
      if constexpr (sizeof(T) == 4) {
        x.w[0] = __float_as_uint(static_cast<const float*>(p)[i]);
      } else {
        x.w[0] = static_cast<const uint16_t*>(p)[i];
      }
    } else {
      const uint4 raw = static_cast<const uint4*>(p)[i];
      x.w[0] = raw.x;
      x.w[1] = raw.y;
      x.w[2] = raw.z;
      x.w[3] = raw.w;
    }
    return x;
  }

  __device__ __forceinline__ void store(void* p, long long i) const {
    if constexpr (kVec == 1) {
      if constexpr (sizeof(T) == 4) {
        static_cast<float*>(p)[i] = __uint_as_float(w[0]);
      } else {
        static_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(w[0]);
      }
    } else {
      static_cast<uint4*>(p)[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }

  __device__ __forceinline__ float get(int k) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[k]);
    } else {
      const uint32_t word = w[kVec == 1 ? 0 : k / 2];
      return __uint_as_float(kVec > 1 && k % 2 ? word & 0xffff0000u
                                               : word << 16);
    }
  }

  __device__ __forceinline__ void put(int k, float v) {
    if constexpr (sizeof(T) == 4) {
      w[k] = __float_as_uint(v);
    } else {
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16(v));
      if (kVec == 1) {
        w[0] = h;
      } else if (k % 2) {
        w[k / 2] = (w[k / 2] & 0xffffu) | (h << 16);
      } else {
        w[k / 2] = (w[k / 2] & 0xffff0000u) | h;
      }
    }
  }
};

// The parameters of kVec channels from channel c (a multiple of kVec):
// one load, zeros for an absent vector.
template <typename T, int kVec>
__device__ __forceinline__ Vec<T, kVec> channels(const void* p, int c) {
  if (p == nullptr) return Vec<T, kVec>{};
  return Vec<T, kVec>::load(static_cast<const T*>(p) + c, 0);
}

// The epilogue of one element, in conv_epilogue_plain's order.
__device__ __forceinline__ float finish(float v, bool has_scale,
                                        bool has_bias, int act,
                                        bool has_residual, float s, float b,
                                        float alpha, float r) {
  if (has_scale) v = __fmul_rn(v, s);
  if (has_bias) v = __fadd_rn(v, b);
  if (act == kRelu) {
    v = isnan(v) ? v : fmaxf(v, 0.0f);
  } else if (act == kPrelu) {
    v = v >= 0.0f ? v : __fmul_rn(v, alpha);
  }
  if (has_residual) v = __fadd_rn(v, r);
  return v;
}

// Channels-last, C a multiple of the vector. The block's threads
// are a multiple of the C / kVec channel groups, so that a grid stride
// moves a thread by whole pixels: its channels, and the parameters it
// loads once, stay fixed. Each step loads up to kUnroll vectors, a grid
// stride apart, and their residuals before it computes any.
template <typename T>
__global__ void __launch_bounds__(kThreads, kGroupBlocksPerSm)
    group_kernel(Args a) {
  constexpr int kVec = 16 / sizeof(T);
  using V = Vec<T, kVec>;
  const bool has_scale = a.scale != nullptr;
  const bool has_bias = a.bias != nullptr;
  const bool has_residual = a.residual != nullptr;
  const int act = a.act;
  const long long vectors = a.n / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int c = static_cast<int>(threadIdx.x % (a.channels / kVec)) * kVec;
  const V s = channels<T, kVec>(a.scale, c);
  const V b = channels<T, kVec>(a.bias, c);
  const V al = channels<T, kVec>(a.alpha, c);
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < vectors; v += kUnroll * stride) {
    V e[kUnroll] = {};
    V r[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * stride < vectors) {
        e[u] = V::load(a.x, v + u * stride);
        if (has_residual) r[u] = V::load(a.residual, v + u * stride);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * stride >= vectors) break;
      V o = {};
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        o.put(k, finish(e[u].get(k), has_scale, has_bias, act, has_residual,
                        s.get(k), b.get(k), al.get(k), r[u].get(k)));
      }
      o.store(a.out, v + u * stride);
    }
  }
}

// Any other layout, one element a step: its channel found by one division
// when the thread starts and then carried from step to step; the
// parameters are reloaded only when it changes.
template <typename T>
__global__ void __launch_bounds__(kThreads) strided_kernel(Args a) {
  using V = Vec<T, 1>;
  const bool has_scale = a.scale != nullptr;
  const bool has_bias = a.bias != nullptr;
  const bool has_residual = a.residual != nullptr;
  const int act = a.act;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long v = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= a.n) return;
  // The thread's first element's place in its channel's run and its
  // channel, and how far one grid stride moves each.
  long long in = v % a.inner;
  int c = static_cast<int>(v / a.inner % a.channels);
  const long long step_in = stride % a.inner;
  const int step_c = static_cast<int>(stride / a.inner % a.channels);
  float s = 0.0f, b = 0.0f, al = 0.0f;
  int loaded = -1;
  for (; v < a.n; v += stride) {
    if (c != loaded) {
      s = channels<T, 1>(a.scale, c).get(0);
      b = channels<T, 1>(a.bias, c).get(0);
      al = channels<T, 1>(a.alpha, c).get(0);
      loaded = c;
    }
    const V e = V::load(a.x, v);
    V r = {};
    if (has_residual) r = V::load(a.residual, v);
    V o = {};
    o.put(0, finish(e.get(0), has_scale, has_bias, act, has_residual, s, b,
                    al, r.get(0)));
    o.store(a.out, v);
    // c < channels and step_c < channels, so one subtraction wraps it.
    in += step_in;
    c += step_c;
    if (in >= a.inner) {
      in -= a.inner;
      ++c;
    }
    if (c >= a.channels) c -= a.channels;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// Blocks of kThreads an SM at a kernel's registers, asked once for each
// kernel (conv_epilogue_prepare asks for every one before any launch, so
// that no query falls inside a CUDA graph's capture); negative: the CUDA
// error of the query.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int& cached) {
  if (cached == 0) {
    int found = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &found, kernel, kThreads, 0);
    if (err != cudaSuccess) return -static_cast<int>(err);
    cached = found > 0 ? found : 1;
  }
  return cached;
}

// A grid that fills every SM at the kernel's occupancy where there is
// work for it, and has a thread for each vector where there is less.
template <typename Kernel>
int launch_grid(Kernel kernel, int& cached, int threads, long long vectors,
                const Args& a, cudaStream_t stream) {
  const int per_sm = blocks_per_sm(kernel, cached);
  if (per_sm < 0) return -per_sm;
  const long long wanted = (vectors + threads - 1) / threads;
  const long long most = static_cast<long long>(sm_count()) * per_sm;
  const int blocks = static_cast<int>(wanted < most ? wanted : most);
  kernel<<<blocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
struct Launcher {
  static constexpr int kVec = 16 / sizeof(T);
  static inline int group_per_sm = 0;
  static inline int strided_per_sm = 0;

  static int prepare() {
    for (const int per_sm :
         {blocks_per_sm(group_kernel<T>, group_per_sm),
          blocks_per_sm(strided_kernel<T>, strided_per_sm)}) {
      if (per_sm < 0) return -per_sm;
    }
    return 0;
  }

  static int launch(const Args& a, cudaStream_t stream) {
    const bool aligned = aligned16(a.x) && aligned16(a.out) &&
                         (a.residual == nullptr || aligned16(a.residual));
    const bool params_aligned =
        (a.scale == nullptr || aligned16(a.scale)) &&
        (a.bias == nullptr || aligned16(a.bias)) &&
        (a.alpha == nullptr || aligned16(a.alpha));
    const int groups = a.channels / kVec;
    if (aligned && params_aligned && a.inner == 1 &&
        a.channels % kVec == 0 && groups <= kThreads) {
      return launch_grid(group_kernel<T>, group_per_sm,
                         kThreads - kThreads % groups, a.n / kVec, a,
                         stream);
    }
    return launch_grid(strided_kernel<T>, strided_per_sm, kThreads, a.n, a,
                       stream);
  }
};

}  // namespace

extern "C" {

// Asks, on the current device, what every launch will need to know (its
// SM count, each kernel's occupancy); returns the first CUDA error, or 0.
int conv_epilogue_prepare() {
  sm_count();
  const int err = Launcher<float>::prepare();
  return err != 0 ? err : Launcher<uint16_t>::prepare();
}

// The epilogue over the n elements of x (dtype kFloat32 or kBFloat16),
// one launch, into out (x itself, or a buffer of its layout), on the
// current device: element i in channel (i / inner) % channels; residual
// (x's layout) or null; scale, bias and alpha (channels values of x's
// type) or null; act kNone, kRelu or kPrelu, alpha given with kPrelu
// alone. Returns the launch's CUDA error (cudaErrorInvalidValue for
// arguments the kernel does not take), or 0.
int conv_epilogue(const void* x, void* out, const void* residual,
                  const void* scale, const void* bias, const void* alpha,
                  long long n, long long inner, int channels, int act,
                  int dtype, void* stream) {
  if (n < 1 || inner < 1 || channels < 1 ||
      n % (inner * channels) != 0 || act < kNone || act > kPrelu ||
      (act == kPrelu) != (alpha != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, out, residual, scale, bias, alpha, n, inner, channels, act};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return Launcher<float>::launch(a, s);
  if (dtype == kBFloat16) return Launcher<uint16_t>::launch(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
