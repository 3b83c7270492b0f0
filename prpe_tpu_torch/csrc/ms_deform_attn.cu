// Multi-scale deformable attention (Zhu et al., Deformable DETR; RT-DETR's
// decoder cross-attention), forward only:
//   out[b, q, h, :] = sum over levels l and points p of
//                     w[b, q, h, l, p] * bilinear(value_l[b, :, :, h, :], loc[b, q, h, l, p])
// value is (B, S, H, D) with the L levels' maps (h_l, w_l) laid one after the
// other along S, row-major; loc is (B, Lq, H, L, P, 2) in [0, 1] (x, y), and
// w is (B, Lq, H, L, P), already softmaxed over the L * P points of a head.
// Both are fp32; value and out are bf16 or fp32.
//
// Replaces no TPU kernel: the JAX package has no detection transformer. The
// plain version (ops/kernels/ms_deform_attn.py::ms_deform_attn_plain) is the
// published deformable_attention_core_func: one F.grid_sample a level
// (bilinear, align_corners=False, zero padding), a stack, a multiply and a
// sum, each rounding to the activation dtype. Here the sample point's
// source coordinates follow grid_sample's arithmetic in fp32
// (g = 2 * loc - 1, then ((g + 1) * size - 1) / 2), a corner outside the
// map adds nothing, and the whole sum over the 4 corners, L levels and P
// points accumulates in fp32 and rounds once, at the output.
//
// Design: a group of D * sizeof(T) / 4 threads owns one (b, q, h) and one
// 4-byte word of the head's D channels each (two bf16 or one fp32), so the
// group's read of a corner is D * sizeof(T) contiguous bytes: 64 in the
// cell (D 32, bf16, 16 threads). The group's first L * P threads load one
// point's location and weight each, and shuffles hand them to the rest, so
// no thread loads what its neighbours load. Nothing is staged in shared
// memory: the gathers are data-dependent, and L2 (50 MB) holds most of a
// frame's value rows (8400 x 512 bytes) while its 300 queries sample them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxLevels = 8;

struct Args {
  const void* value;
  const float* loc;
  const float* weight;
  void* out;
  int batch, len_v, heads, len_q, levels, points;
  int height[kMaxLevels], width[kMaxLevels], start[kMaxLevels];
};

// the 4-byte word of channels a thread owns, as fp32
__device__ __forceinline__ float2 load_word(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_word(const float* p) { return make_float2(*p, 0.0f); }

__device__ __forceinline__ void store_word(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ void store_word(float* p, float2 v) { *p = v.x; }

// grid_sample's source coordinate of normalised position `loc` on an axis of
// `size` cells (align_corners=False)
__device__ __forceinline__ float source(float loc, int size) {
  const float g = __fsub_rn(__fmul_rn(2.0f, loc), 1.0f);
  return __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f), 2.0f);
}

template <typename T, int kGroup>
__global__ void __launch_bounds__(kThreads) msda_kernel(Args a) {
  constexpr int kPerWord = 4 / (int)sizeof(T);  // channels a thread owns
  const int lane = threadIdx.x % kGroup;
  const long long group = (long long)blockIdx.x * (kThreads / kGroup) + threadIdx.x / kGroup;
  const long long groups = (long long)a.batch * a.len_q * a.heads;
  // whole groups leave together, so the shuffles below see their full group
  if (group >= groups) return;
  const int h = (int)(group % a.heads);
  const long long bq = group / a.heads;
  const int b = (int)(bq / a.len_q);
  const int dim = kGroup * kPerWord;
  const int points = a.levels * a.points;
  // the lanes of this group within its warp
  const unsigned first_lane = threadIdx.x % 32 / kGroup * kGroup;
  const unsigned mask = kGroup == 32 ? 0xffffffffu : ((1u << (kGroup % 32)) - 1u) << first_lane;
  const float* loc = a.loc + group * points * 2;
  const float* wgt = a.weight + group * points;
  const T* value = static_cast<const T*>(a.value) + ((long long)b * a.len_v * a.heads + h) * dim +
                   lane * kPerWord;
  const long long row = (long long)a.heads * dim;  // elements from one position to the next
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int first = 0; first < points; first += kGroup) {
    // thread j of the group loads point first + j
    float lx = 0.0f, ly = 0.0f, lw = 0.0f;
    if (first + lane < points) {
      lx = loc[(first + lane) * 2];
      ly = loc[(first + lane) * 2 + 1];
      lw = wgt[first + lane];
    }
    const int count = points - first < kGroup ? points - first : kGroup;
    for (int k = 0; k < count; ++k) {
      const float x = __shfl_sync(mask, lx, k, kGroup);
      const float y = __shfl_sync(mask, ly, k, kGroup);
      const float w = __shfl_sync(mask, lw, k, kGroup);
      const int level = (first + k) / a.points;
      const int hh = a.height[level], ww = a.width[level];
      const float sx = source(x, ww), sy = source(y, hh);
      // outside [-1, size] (NaN included) no corner lies on the map
      if (!(sx > -1.0f && sx < (float)ww && sy > -1.0f && sy < (float)hh)) continue;
      const float fx = floorf(sx), fy = floorf(sy);
      const int x0 = (int)fx, y0 = (int)fy;
      const float tx = sx - fx, ty = sy - fy;
      // grid_sample's corner weights: nw, ne, sw, se
      const float cw[4] = {(1.0f - tx) * (1.0f - ty), tx * (1.0f - ty), (1.0f - tx) * ty, tx * ty};
      float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int xc = x0 + (c & 1), yc = y0 + (c >> 1);
        if (xc < 0 || xc >= ww || yc < 0 || yc >= hh) continue;
        const float2 v = load_word(value + (long long)(a.start[level] + yc * ww + xc) * row);
        s0 = fmaf(cw[c], v.x, s0);
        s1 = fmaf(cw[c], v.y, s1);
      }
      acc0 = fmaf(w, s0, acc0);
      acc1 = fmaf(w, s1, acc1);
    }
  }
  T* out = static_cast<T*>(a.out) + group * dim + lane * kPerWord;
  store_word(out, make_float2(acc0, acc1));
}

template <typename T, int kGroup>
cudaError_t run(const Args& a, cudaStream_t stream) {
  const long long groups = (long long)a.batch * a.len_q * a.heads;
  const long long per_block = kThreads / kGroup;
  const long long blocks = (groups + per_block - 1) / per_block;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  msda_kernel<T, kGroup><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* value, const void* loc, const void* weight, void* out, const int* shapes,
           int batch, int len_v, int heads, int dim, int len_q, int levels, int points,
           int device, void* stream) {
  if (batch < 0 || len_v <= 0 || heads <= 0 || dim <= 0 || len_q < 0 || levels <= 0 ||
      levels > kMaxLevels || points <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{value, static_cast<const float*>(loc), static_cast<const float*>(weight), out,
         batch, len_v, heads, len_q, levels, points, {}, {}, {}};
  int at = 0;
  for (int l = 0; l < levels; ++l) {
    a.height[l] = shapes[2 * l];
    a.width[l] = shapes[2 * l + 1];
    if (a.height[l] <= 0 || a.width[l] <= 0) return (int)cudaErrorInvalidValue;
    a.start[l] = at;
    at += a.height[l] * a.width[l];
  }
  if (at != len_v) return (int)cudaErrorInvalidValue;
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device)
    return (int)cudaErrorInvalidDevice;
  const cudaStream_t s = (cudaStream_t)stream;
  // a head of 64 bytes (bf16 D 32, fp32 D 16) or 128 (bf16 D 64, fp32 D 32)
  switch (dim * (int)sizeof(T)) {
    case 64: return (int)run<T, 16>(a, s);
    case 128: return (int)run<T, 32>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int prpe_msda_f32(const void* value, const void* loc, const void* weight, void* out,
                             const int* shapes, int batch, int len_v, int heads, int dim,
                             int len_q, int levels, int points, int device, void* stream) {
  return launch<float>(value, loc, weight, out, shapes, batch, len_v, heads, dim, len_q, levels,
                       points, device, stream);
}

extern "C" int prpe_msda_bf16(const void* value, const void* loc, const void* weight, void* out,
                              const int* shapes, int batch, int len_v, int heads, int dim,
                              int len_q, int levels, int points, int device, void* stream) {
  return launch<bf16>(value, loc, weight, out, shapes, batch, len_v, heads, dim, len_q, levels,
                      points, device, stream);
}
