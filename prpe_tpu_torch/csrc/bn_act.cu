// Eval BatchNorm and the activation right after it, in one pass:
//   y = act(round(round(x * scale) + bias))
// or, with a residual operand r of x's layout (a bottleneck's shortcut, a
// RepVGG block's other branch), the add between them too:
//   y = act(round(round(round(x * scale) + bias) + r))
// over a tensor that lies in memory as (outer, C, inner): NCHW is (N, C, H*W),
// channels-last (N, H*W, C) with inner 1, and (N, C) has inner 1. scale and
// bias are the per-channel constants that eval BatchNorm folds from its
// running statistics, already in the activation dtype
// (prpe_tpu_torch/nn/common.py::BatchNorm computes them once and caches them);
// act is none, SiLU, PReLU with a per-channel alpha, or ReLU.
//
// Replaces no TPU kernel: the JAX package applies inference BatchNorm as
// x * scale + bias in the activation dtype (prpe_tpu/nn/common.py::
// inference_bn) and XLA fuses that into its neighbours. Eager PyTorch ran it
// as a multiply and an add in ATen's generic broadcast kernel after eight
// launches on the constants, and the activation as a pass of its own.
//
// Exactness: each step rounds to the activation dtype where ATen's separate
// kernels store it: after the product, after the sum, after the residual's
// add and after the activation. The product and the sums are __fmul_rn /
// __fadd_rn, which nvcc never contracts into an FMA; ATen's add of two bf16
// tensors is the fp32 sum of the stored values, rounded once, and fp32
// addition is commutative, so either side may hold the residual. SiLU is
// ATen's x / (1 + exp(-x)) in fp32 (expf, IEEE division); PReLU is
// where(x >= 0, x, round(alpha * x)); ReLU is ATen's clamp_min(x, 0): NaN
// kept, else fmaxf(x, 0) in fp32. So the output equals the plain version
// (ops/kernels/bn_act.py::bn_act_plain) bit for bit.
//
// What bounds it on the H100: bytes. One read and one write of the tensor
// (4 bytes an element in bf16) against about 30 fp32 instructions an
// element for SiLU, which 132 SMs issue in about the same time, so the
// design keeps the work around the arithmetic small:
//   - 16-byte loads and stores (8 bf16 or 4 fp32) wherever the layout
//     allows them, in one of four routes. Channels-last and (N, C) tensors
//     (inner 1) with C a multiple of the vector: a vector holds consecutive
//     channels; where C over the vector divides the block, every vector a
//     thread touches holds the same channels, whose constants it loads into
//     registers once ("fixed"), else it reads them from shared memory each
//     time ("run"). NCHW tensors: a vector lies in one channel where H*W is
//     a multiple of the vector ("one channel"), else in at most two
//     ("straddle": IR-50's 14x14 and 7x7 planes). Anything else, or a
//     pointer off a 16-byte boundary, takes one element at a time.
//   - The routes that read the constants per vector stage them in shared
//     memory once per block, in the activation dtype; a grid-stride loop
//     over as many blocks as fit on the card at once walks the tensor, one
//     vector a thread at a time: two or four in flight measured the same or
//     slower in the cascade (SiLU's arithmetic, not the memory's latency,
//     holds its routes below the bytes' bound).
//   - Channel indices come from multiply-high divisions by divisors
//     prepared on the host, not from integer division.
//   - The residual is a kernel of its own (bn_act_residual_kernel, the
//     same body with the add compiled in), so the routes without one keep
//     their code. Its vector lies at x's offset (same sizes and strides,
//     checked on the host) and costs one more 16-byte load. Reading x and
//     the residual and writing y moves three tensors' bytes where the
//     separate BatchNorm, add and activation moved seven. A streaming load
//     of the residual (__ldcs) measured within 2 % of a plain one either
//     way, and slower with x and y streamed too, so the loads are plain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <unordered_map>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4096;  // three fp32 tables of C fit in 48 KB of shared memory
enum { kNone = 0, kSilu = 1, kPrelu = 2, kRelu = 3 };
// the routes (see the top of the file): a vector in one channel, in at most
// two, over consecutive channels read from shared memory or held in
// registers; one element an item
enum { kOneChannel = 0, kStraddle = 1, kChannelRun = 2, kChannelFixed = 3, kElement = 4 };

// n / d for n, d < 2^31 as a multiply-high and a shift (ATen's IntDivider)
struct Div {
  unsigned d, m, s;
};

Div make_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, (unsigned)m, s};
}

__device__ __forceinline__ unsigned divide(const Div& q, unsigned n) {
  return (__umulhi(n, q.m) + n) >> q.s;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v as ATen's kernel stores it in T for the next one to read
template <typename T>
__device__ __forceinline__ float stored(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, int kAct, bool kRes>
__device__ __forceinline__ T apply(T x, float s, float b, float a, T r) {
  float v = stored<T>(__fmul_rn(to_f(x), s));
  v = stored<T>(__fadd_rn(v, b));
  if (kRes) v = stored<T>(__fadd_rn(v, to_f(r)));
  if (kAct == kSilu) v = v / (1.0f + expf(-v));
  if (kAct == kPrelu && !(v >= 0.0f)) v = __fmul_rn(a, v);
  if (kAct == kRelu && v == v) v = fmaxf(v, 0.0f);
  return from_f<T>(v);
}

struct Args {
  const void* x;
  const void* scale;
  const void* bias;
  const void* alpha;
  const void* residual;  // bn_act_residual_kernel only
  void* y;
  unsigned items;     // vectors (kElement: elements) of the tensor
  int channels;
  unsigned inner;
  Div per_channel;    // items (kStraddle: elements) of one channel's plane
  Div channel_count;  // C (kChannelRun, kChannelFixed: C over the vector)
};

// the kVec constants of a vector over consecutive channels, group g
template <typename T>
__device__ __forceinline__ void load_group(const T* scale, const T* bias, const T* alpha,
                                           unsigned g, bool prelu, uint4& s, uint4& b,
                                           uint4& a) {
  s = reinterpret_cast<const uint4*>(scale)[g];
  b = reinterpret_cast<const uint4*>(bias)[g];
  a = prelu ? reinterpret_cast<const uint4*>(alpha)[g] : s;
}

template <typename T, int kAct, int kMode, bool kRes>
__device__ __forceinline__ void bn_act_body(const Args& a) {
  constexpr int kVec = kMode == kElement ? 1 : 16 / (int)sizeof(T);
  using Item = typename std::conditional<kMode == kElement, T, uint4>::type;
  const T* scale = static_cast<const T*>(a.scale);
  const T* bias = static_cast<const T*>(a.bias);
  const T* alpha = static_cast<const T*>(a.alpha);
  extern __shared__ uint4 table_raw[];
  T* t_scale = reinterpret_cast<T*>(table_raw);
  T* t_bias = t_scale + a.channels;
  T* t_alpha = t_bias + a.channels;
  uint4 fs, fb, fa;  // kChannelFixed: this thread's constants
  if constexpr (kMode == kChannelFixed) {
    load_group(scale, bias, alpha, threadIdx.x % a.channel_count.d, kAct == kPrelu, fs, fb, fa);
  } else {
    for (int c = threadIdx.x; c < a.channels; c += kThreads) {
      t_scale[c] = scale[c];
      t_bias[c] = bias[c];
      if (kAct == kPrelu) t_alpha[c] = alpha[c];
    }
    __syncthreads();
  }

  const Item* __restrict__ x = static_cast<const Item*>(a.x);
  const Item* __restrict__ r = static_cast<const Item*>(a.residual);
  Item* __restrict__ y = static_cast<Item*>(a.y);
  const unsigned step = gridDim.x * kThreads;
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < a.items; i += step) {
    const Item in = x[i];
    Item res{};
    if constexpr (kRes) res = r[i];
    Item out;
    const T* e = reinterpret_cast<const T*>(&in);
    const T* rv = reinterpret_cast<const T*>(&res);
    T* o = reinterpret_cast<T*>(&out);
    if constexpr (kMode == kChannelRun || kMode == kChannelFixed) {
      uint4 sr = fs, br = fb, ar = fa;
      if constexpr (kMode == kChannelRun) {
        const unsigned g = i - divide(a.channel_count, i) * a.channel_count.d;
        load_group(t_scale, t_bias, t_alpha, g, kAct == kPrelu, sr, br, ar);
      }
      const T* sv = reinterpret_cast<const T*>(&sr);
      const T* bv = reinterpret_cast<const T*>(&br);
      const T* av = reinterpret_cast<const T*>(&ar);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        o[j] = apply<T, kAct, kRes>(e[j], to_f(sv[j]), to_f(bv[j]), to_f(av[j]), rv[j]);
      }
    } else if constexpr (kMode == kStraddle) {
      // the vector's first element is r0 into channel c0's plane; from
      // element inner - r0 on (at least 1, as inner > kVec) it is in the next
      const unsigned e0 = i * kVec;
      const unsigned q = divide(a.per_channel, e0);
      const unsigned r0 = e0 - q * a.inner;
      const unsigned c0 = q - divide(a.channel_count, q) * a.channel_count.d;
      const unsigned c1 = c0 + 1 == (unsigned)a.channels ? 0 : c0 + 1;
      const int split = (int)(a.inner - r0);
      const float s0 = to_f(t_scale[c0]), s1 = to_f(t_scale[c1]);
      const float b0 = to_f(t_bias[c0]), b1 = to_f(t_bias[c1]);
      const float a0 = kAct == kPrelu ? to_f(t_alpha[c0]) : 0.0f;
      const float a1 = kAct == kPrelu ? to_f(t_alpha[c1]) : 0.0f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const bool next = j >= split;
        o[j] = apply<T, kAct, kRes>(e[j], next ? s1 : s0, next ? b1 : b0, next ? a1 : a0,
                                    rv[j]);
      }
    } else {
      // kOneChannel (i counts vectors) and kElement (i counts elements)
      const unsigned q = divide(a.per_channel, i);
      const unsigned c = q - divide(a.channel_count, q) * a.channel_count.d;
      const float s = to_f(t_scale[c]);
      const float b = to_f(t_bias[c]);
      const float al = kAct == kPrelu ? to_f(t_alpha[c]) : 0.0f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = apply<T, kAct, kRes>(e[j], s, b, al, rv[j]);
    }
    y[i] = out;
  }
}

template <typename T, int kAct, int kMode>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(Args a) {
  bn_act_body<T, kAct, kMode, false>(a);
}

template <typename T, int kAct, int kMode>
__global__ void __launch_bounds__(kThreads) bn_act_residual_kernel(Args a) {
  bn_act_body<T, kAct, kMode, true>(a);
}

// the kernel of one route, with the residual's add or without
template <typename T, int kAct, int kMode, bool kRes>
auto kernel_of() -> void (*)(Args) {
  if constexpr (kRes) return bn_act_residual_kernel<T, kAct, kMode>;
  else return bn_act_kernel<T, kAct, kMode>;
}

// Blocks of one instantiation that fit on device `device` at once with
// `smem` bytes of dynamic shared memory each. The occupancy query costs more
// host time than the launch, so its answer is kept for each (device, smem)
// pair the instantiation has seen; the cell's 240 sites have a few dozen.
template <typename T, int kAct, int kMode, bool kRes>
cudaError_t resident_blocks(int device, size_t smem, unsigned* blocks) {
  static std::mutex lock;
  static std::unordered_map<uint64_t, unsigned> known;
  const uint64_t key = ((uint64_t)(unsigned)device << 32) | (uint64_t)smem;
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = known.find(key);
  if (hit != known.end()) {
    *blocks = hit->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of<T, kAct, kMode, kRes>(), kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = known[key] = (unsigned)(per_sm > 0 ? per_sm : 1) * (unsigned)sms;
  return cudaSuccess;
}

template <typename T, int kAct, int kMode, bool kRes>
cudaError_t run(const Args& a, int device, cudaStream_t stream) {
  const size_t smem =
      kMode == kChannelFixed ? 0 : (size_t)(kAct == kPrelu ? 3 : 2) * a.channels * sizeof(T);
  unsigned resident = 0;
  const cudaError_t err = resident_blocks<T, kAct, kMode, kRes>(device, smem, &resident);
  if (err != cudaSuccess) return err;
  if (a.items == 0) return cudaSuccess;
  const unsigned wanted = (a.items + kThreads - 1) / kThreads;
  const unsigned blocks = wanted < resident ? wanted : resident;
  if constexpr (kRes)
    bn_act_residual_kernel<T, kAct, kMode><<<blocks, kThreads, smem, stream>>>(a);
  else
    bn_act_kernel<T, kAct, kMode><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int kAct, bool kRes>
cudaError_t by_mode(int mode, const Args& a, int device, cudaStream_t stream) {
  switch (mode) {
    case kOneChannel:
      return run<T, kAct, kOneChannel, kRes>(a, device, stream);
    case kStraddle:
      return run<T, kAct, kStraddle, kRes>(a, device, stream);
    case kChannelRun:
      return run<T, kAct, kChannelRun, kRes>(a, device, stream);
    case kChannelFixed:
      return run<T, kAct, kChannelFixed, kRes>(a, device, stream);
    default:
      return run<T, kAct, kElement, kRes>(a, device, stream);
  }
}

template <typename T, int kAct>
cudaError_t by_residual(int mode, const Args& a, int device, cudaStream_t stream) {
  return a.residual ? by_mode<T, kAct, true>(mode, a, device, stream)
                    : by_mode<T, kAct, false>(mode, a, device, stream);
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, const void* alpha,
           const void* residual, void* y, int outer, int channels, int inner, int act,
           int device, void* stream) {
  if (outer <= 0 || channels <= 0 || channels > kMaxChannels || inner <= 0 || act < kNone ||
      act > kRelu || (act == kPrelu && alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / (int)sizeof(T);
  const long long n = (long long)outer * channels * inner;
  if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const auto on16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const bool aligned = on16(x) && on16(y) && (residual == nullptr || on16(residual));
  Args a{x, scale, bias, alpha, residual, y, 0, channels, (unsigned)inner, {}, {}};
  int mode;
  long long items = n / kVec;
  if (aligned && inner % kVec == 0) {
    mode = kOneChannel;
    a.per_channel = make_div((unsigned)(inner / kVec));
    a.channel_count = make_div((unsigned)channels);
  } else if (aligned && inner == 1 && channels % kVec == 0) {
    const int groups = channels / kVec;
    const bool fixed = kThreads % groups == 0 && on16(scale) && on16(bias) &&
                       (act != kPrelu || on16(alpha));
    mode = fixed ? kChannelFixed : kChannelRun;
    a.channel_count = make_div((unsigned)groups);
  } else if (aligned && inner > kVec && n % kVec == 0) {
    mode = kStraddle;
    a.per_channel = make_div((unsigned)inner);
    a.channel_count = make_div((unsigned)channels);
  } else {
    mode = kElement;
    items = n;
    a.per_channel = make_div((unsigned)inner);
    a.channel_count = make_div((unsigned)channels);
  }
  a.items = (unsigned)items;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case kSilu:
      return (int)by_residual<T, kSilu>(mode, a, device, s);
    case kPrelu:
      return (int)by_residual<T, kPrelu>(mode, a, device, s);
    case kRelu:
      return (int)by_residual<T, kRelu>(mode, a, device, s);
    default:
      return (int)by_residual<T, kNone>(mode, a, device, s);
  }
}

}  // namespace

// residual: null, or a tensor of x's dtype, sizes and strides
extern "C" int prpe_bn_act_f32(const void* x, const void* scale, const void* bias,
                               const void* alpha, const void* residual, void* y, int outer,
                               int channels, int inner, int act, int device, void* stream) {
  return launch<float>(x, scale, bias, alpha, residual, y, outer, channels, inner, act, device,
                       stream);
}

extern "C" int prpe_bn_act_bf16(const void* x, const void* scale, const void* bias,
                                const void* alpha, const void* residual, void* y, int outer,
                                int channels, int inner, int act, int device, void* stream) {
  return launch<bf16>(x, scale, bias, alpha, residual, y, outer, channels, inner, act, device,
                      stream);
}
