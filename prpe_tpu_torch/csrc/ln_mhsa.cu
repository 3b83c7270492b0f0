// Fused pre-LN attention half-block of a ViT block:
//   out = x + proj(MHSA(q(LN(x)), k(LN(x)), v(LN(x))))
//
// Replaces prpe_tpu/ops/pallas/attention_kernel.py::_ln_mhsa_kernel (entry
// point fused_ln_mhsa, PRPE_ATTN_MODE=pallas_lnfused). The numerics are
// those of the Pallas body, not of its XLA oracle: LayerNorm statistics in
// fp32, two passes (mean, then the mean of squared deviations), eps inside
// the square root, scale and shift in fp32, rounded to the input dtype; each
// projection accumulates in fp32, adds its fp32 bias in fp32 and rounds
// once; the attention is that of mhsa_core.cuh; the residual adds the
// rounded projection to x in the input dtype.
//
// Design: four launches on the caller's stream behind one C entry point,
// through a workspace of four (B*T, C) planes in the input dtype that the
// wrapper allocates:
//   1. LayerNorm, one warp per row, into plane 0;
//   2. a tiled GEMM for q|k|v (grid.z = 3) into planes 1..3, bias in the
//      epilogue;
//   3. the attention kernel over the packed planes, into plane 0 (the
//      normalised rows are dead by then);
//   4. a tiled GEMM for the output projection with bias and residual.
// The TPU kernel groups 1, 2 or 4 images per program so that its in-kernel
// GEMMs have M = images * T rows; here every GEMM runs over all B*T rows at
// once, so that grouping has no counterpart. The weights keep the port's
// (out, in) layout and are read as a column-major B operand with ld = in:
// no transposed copy.
//
// What bounds it on the H100: 1.019 GFLOP per ViT-B image (four
// 192x768x768 GEMMs and the attention) against about 2.4 MB of bf16 bytes
// in and out per image, about 430 FLOP per byte: above the bf16 ridge, so
// the bound is operations. The bf16 GEMM multiplies WMMA 16x16x16 fragments
// on the tensor cores from single-buffered 128x128x32 shared-memory tiles;
// the fp32 GEMM uses CUDA-core FMAs on 64x64x16 tiles. Both are simple
// first versions: no TMA, no wgmma, no overlap of loads and products.

#include "mhsa_core.cuh"

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

// ------------------------------------------------------------- LayerNorm

constexpr int kLnRows = kThreads / 32;  // rows per block, one warp each

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, T* __restrict__ y, int rows, int cols,
                 float eps) {
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + (size_t)row * cols;
  T* yr = y + (size_t)row * cols;
  float sum = 0.0f;
  for (int c = lane; c < cols; c += 32) sum += to_float(xr[c]);
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float mu = sum / cols;
  float sq = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    const float d = to_float(xr[c]) - mu;
    sq += d * d;
  }
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
  const float inv = 1.0f / sqrtf(sq / cols + eps);
  for (int c = lane; c < cols; c += 32) {
    yr[c] = from_float<T>((to_float(xr[c]) - mu) * inv * g[c] + b[c]);
  }
}

// ------------------------------------------------------------------ GEMM

// out[z] = round(a @ w[z]^T + bias[z]) (+ residual, after the rounding)
template <typename T>
struct Gemm {
  const T* a;            // (m, k) row-major
  const T* w[3];         // (n, k) row-major: column-major B operand, ld = k
  const float* bias[3];  // (n,)
  T* out[3];             // (m, n) row-major
  const T* residual;     // (m, n) or null
  int m, n, k;
};

// part z of a three-pointer array, without indexing it at run time (which
// would copy the kernel parameter to local memory)
template <typename P>
__device__ __forceinline__ P part(P const (&p)[3], int z) {
  return z == 0 ? p[0] : z == 1 ? p[1] : p[2];
}

template <typename T>
__device__ __forceinline__ void store_out(const Gemm<T>& g, const float* bias, T* out, int row,
                                          int col, float acc) {
  const T y = from_float<T>(acc + bias[col]);
  const size_t at = (size_t)row * g.n + col;
  out[at] = g.residual ? from_float<T>(to_float(g.residual[at]) + to_float(y)) : y;
}

// bf16: 128x128 block tile, 32-deep k steps, 8 warps as 2 (m) x 4 (n), each
// warp 64x32 = 4x2 WMMA accumulators
constexpr int kBM = 128, kBN = 128, kBK = 32, kLd = kBK + 8;

__global__ void __launch_bounds__(kThreads) gemm_bf16_kernel(Gemm<bf16> g) {
  __shared__ __align__(128) bf16 as[kBM * kLd];
  __shared__ __align__(128) bf16 bs[kBN * kLd];
  __shared__ __align__(128) float stage[kWarps][16 * 16];
  const int z = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const bf16* w = part(g.w, z);
  const float* bias = part(g.bias, z);
  bf16* out = part(g.out, z);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < g.k; k0 += kBK) {
    __syncthreads();
    // 16-byte vectors; k = heads * dim is a multiple of 16 (bad_shape
    // checks dim), so a vector is wholly inside or wholly past the edge
    for (int idx = tid; idx < kBM * (kBK / 8); idx += kThreads) {
      const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (k0 + c < g.k) {
        if (m0 + r < g.m) va = *reinterpret_cast<const uint4*>(g.a + (size_t)(m0 + r) * g.k + k0 + c);
        if (n0 + r < g.n) vb = *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * g.k + k0 + c);
      }
      *reinterpret_cast<uint4*>(as + r * kLd + c) = va;
      *reinterpret_cast<uint4*>(bs + r * kLd + c) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], bs + (wn * 32 + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, as + (wm * 64 + i * 16) * kLd + kk, kLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
  }

  // epilogue through a per-warp 16x16 fp32 staging tile
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wm * 64 + i * 16 + e / 16;
        const int col = n0 + wn * 32 + j * 16 + e % 16;
        if (row < g.m && col < g.n) store_out(g, bias, out, row, col, st[e]);
      }
      __syncwarp();
    }
  }
}

// fp32: 64x64 block tile, 16-deep k steps, each thread a 4x4 grid of
// outputs strided by 16 (conflict-free shared reads)
constexpr int kFM = 64, kFN = 64, kFK = 16;

__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(Gemm<float> g) {
  __shared__ float as[kFK][kFM + 4];
  __shared__ float bs[kFK][kFN + 4];
  const int z = blockIdx.z;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* w = part(g.w, z);
  const float* bias = part(g.bias, z);
  float* out = part(g.out, z);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < g.k; k0 += kFK) {
    __syncthreads();
    for (int idx = tid; idx < kFM * kFK; idx += kThreads) {
      const int r = idx / kFK, c = idx % kFK;
      const bool in_k = k0 + c < g.k;
      as[c][r] = in_k && m0 + r < g.m ? g.a[(size_t)(m0 + r) * g.k + k0 + c] : 0.0f;
      bs[c][r] = in_k && n0 + r < g.n ? w[(size_t)(n0 + r) * g.k + k0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[kk][ty + 16 * i];
        b[i] = bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < g.m && col < g.n) store_out(g, bias, out, row, col, acc[i][j]);
    }
  }
}

int launch_gemm(const Gemm<bf16>& g, int parts, cudaStream_t stream) {
  const dim3 grid((g.m + kBM - 1) / kBM, (g.n + kBN - 1) / kBN, parts);
  gemm_bf16_kernel<<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

int launch_gemm(const Gemm<float>& g, int parts, cudaStream_t stream) {
  const dim3 grid((g.m + kFM - 1) / kFM, (g.n + kFN - 1) / kFN, parts);
  gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- entry

template <typename T>
int ln_mhsa(const T* x, const float* ln_w, const float* ln_b, const T* wq, const float* bq,
            const T* wk, const float* bk, const T* wv, const float* bv, const T* wo,
            const float* bo, T* out, T* ws, int batch, int seq, int channels, int heads,
            float eps, float scale, cudaStream_t stream) {
  if (heads <= 0 || channels <= 0 || channels % heads) return (int)cudaErrorInvalidValue;
  const int dim = channels / heads;
  if (bad_shape(batch, seq, heads, dim)) return (int)cudaErrorInvalidValue;
  const int m = batch * seq;
  const size_t plane = (size_t)m * channels;
  T* xn = ws;
  T* q = ws + plane;
  T* k = q + plane;
  T* v = k + plane;

  layernorm_kernel<T><<<(m + kLnRows - 1) / kLnRows, kThreads, 0, stream>>>(
      x, ln_w, ln_b, xn, m, channels, eps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const Gemm<T> qkv{xn, {wq, wk, wv}, {bq, bk, bv}, {q, k, v}, nullptr, m, channels, channels};
  if ((err = launch_gemm(qkv, 3, stream))) return err;
  if ((err = launch_mhsa(q, k, v, xn, packed_strides(seq, heads, dim), batch, seq, heads, dim,
                         scale, stream)))
    return err;
  const Gemm<T> proj{xn, {wo, wo, wo}, {bo, bo, bo}, {out, out, out}, x, m, channels, channels};
  return launch_gemm(proj, 1, stream);
}

}  // namespace

#define PRPE_LN_MHSA_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* x, const void* ln_w, const void* ln_b, const void* wq,      \
                      const void* bq, const void* wk, const void* bk, const void* wv,          \
                      const void* bv, const void* wo, const void* bo, void* out, void* ws,     \
                      int batch, int seq, int channels, int heads, float eps, float scale,     \
                      void* stream) {                                                          \
    return ln_mhsa<T>((const T*)x, (const float*)ln_w, (const float*)ln_b, (const T*)wq,       \
                      (const float*)bq, (const T*)wk, (const float*)bk, (const T*)wv,          \
                      (const float*)bv, (const T*)wo, (const float*)bo, (T*)out, (T*)ws,       \
                      batch, seq, channels, heads, eps, scale, (cudaStream_t)stream);          \
  }

PRPE_LN_MHSA_ENTRY(prpe_ln_mhsa_f32, float)
PRPE_LN_MHSA_ENTRY(prpe_ln_mhsa_bf16, bf16)
