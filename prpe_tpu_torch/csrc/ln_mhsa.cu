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
//   2. a tiled GEMM for q|k|v (three weights in one launch) into planes
//      1..3, bias in the epilogue;
//   3. the attention kernel over the packed planes, into plane 0 (the
//      normalised rows are dead by then);
//   4. a tiled GEMM for the output projection with bias and residual.
// The TPU kernel groups 1, 2 or 4 images per program so that its in-kernel
// GEMMs have M = images * T rows; here every GEMM runs over all B*T rows at
// once, so that grouping has no counterpart. The weights keep the port's
// (out, in) layout, which is the K-major B operand wgmma reads: no
// transposed copy. Stages 1 and 2/4 are also exported alone
// (prpe_layernorm_bf16, prpe_linear_bf16) so that each can be timed.
//
// What bounds it on the H100: 1.019 GFLOP per ViT-B image (four
// 192x768x768 GEMMs and the attention) against about 2.4 MB of bf16 bytes
// in and out per image, about 430 FLOP per byte: above the bf16 ridge, so
// the bound is operations, nearly all of them in the GEMMs. The bf16 GEMM
// therefore runs on wgmma with its loads in flight behind the products
// (below); the fp32 GEMM uses CUDA-core FMAs on 64x64x16 tiles (fp32 has no
// tensor-core path of the same precision) and is not on the bf16 main path.

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

// bf16 on wgmma: a 192 x 192 output tile per block of three warpgroups (64
// rows each), so that the ViT-B GEMMs at B = 32 (M = 6144, N = 768) make 128
// tiles, one wave on 132 SMs. 64-deep k steps go through a ring of kGStages
// shared-memory stages. One thread fills a stage with two TMA boxes (192 rows
// x 64 values of a, and of w, which is K-major as stored; 128-byte swizzle)
// completing on the stage's mbarrier. Each k step waits for its stage and
// issues its m64n192k16 wgmmas; the step before stays in flight until every
// warpgroup has issued this one, then its stage is refilled with the step
// kGStages ahead, so that kGStages - 1 steps of loads are always in flight.
// The epilogue adds the fp32 bias to the fp32 sum, rounds once, adds the
// residual in bf16, and stores 16-byte vectors.
constexpr int kGM = 192, kGN = 192, kGK = 64, kGStages = 4, kGThreads = 384;
constexpr int kGBox = kGM * kGK * 2;  // bytes of one operand box (kGN == kGM)
constexpr size_t kGSmem = (size_t)kGStages * 2 * kGBox + 1024;  // 193 KB: one block an SM

// round(float(a) + float(b)) for eight bf16 pairs, as the residual add of
// store_out
__device__ __forceinline__ uint4 add_bf16x8(uint4 a, uint4 b) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  uint4 r;
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(pa[i]), fb = __bfloat1622float2(pb[i]);
    pr[i] = __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
  }
  return r;
}

__global__ void __launch_bounds__(kGThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw0,
                 const __grid_constant__ CUtensorMap mw1, const __grid_constant__ CUtensorMap mw2,
                 Gemm<bf16> g) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kGStages];
  unsigned char* sm = align1024(smem_raw);  // stage s: A box, then B box
  // blockIdx.x runs over (part, column tile) and blockIdx.y over row tiles,
  // so the blocks that read one row block of a run together and a streams
  // through L2 once
  const int ntn = (g.n + kGN - 1) / kGN;
  const int z = blockIdx.x / ntn;
  const int m0 = blockIdx.y * kGM, n0 = (blockIdx.x % ntn) * kGN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const CUtensorMap* mw = z == 0 ? &mw0 : z == 1 ? &mw1 : &mw2;
  const float* bias = part(g.bias, z);
  bf16* out = part(g.out, z);
  const int nk = (g.k + kGK - 1) / kGK;

  auto load = [&](int kt, int slot) {  // one thread
    unsigned char* st = sm + slot * 2 * kGBox;
    mbar_expect(&full[slot], 2 * kGBox);
    tma_load(st, &ma, kt * kGK, m0, &full[slot]);
    tma_load(st + kGBox, mw, kt * kGK, n0, &full[slot]);
  };
  if (tid == 0) {
    for (int s = 0; s < kGStages; ++s) mbar_init(&full[s]);
  }
  mbar_init_visible();
  if (tid == 0) {
    for (int s = 0; s < kGStages && s < nk; ++s) load(s, s);
  }

  float acc[kGN / 2];
#pragma unroll
  for (int i = 0; i < kGN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % kGStages;
    const unsigned char* st = sm + slot * 2 * kGBox;
    mbar_wait(&full[slot], (kt / kGStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk)
      wgmma_ss<kGN>(acc, desc_k(st, 128, wg * 64, kk), desc_k(st + kGBox, 128, 0, kk));
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's step kt - 1 is done
    __syncthreads();  // ... and every other's: its stage is free
    if (tid == 0 && kt >= 1 && kt - 1 + kGStages < nk)
      load(kt - 1 + kGStages, (kt - 1) % kGStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue: rows r and r + 8 of this thread, 16-byte stores after a quad
  // exchange (n is a multiple of 8: a vector is wholly inside or outside)
  const int lane = tid & 31, quad = lane & 3;
  const int r = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int grp = 0; grp < kGN / 32; ++grp) {
    float2 b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = n0 + 32 * grp + 8 * i + 2 * quad;
      b[i] = col < g.n ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int a = 16 * grp + 2 * h;  // blocks 4 grp .. 4 grp + 3 of row half h
      uint4 y = quad_gather(pack_bf16(acc[a] + b[0].x, acc[a + 1] + b[0].y),
                            pack_bf16(acc[a + 4] + b[1].x, acc[a + 5] + b[1].y),
                            pack_bf16(acc[a + 8] + b[2].x, acc[a + 9] + b[2].y),
                            pack_bf16(acc[a + 12] + b[3].x, acc[a + 13] + b[3].y), quad);
      const int row = r + 8 * h, col = n0 + 32 * grp + 8 * quad;
      if (row < g.m && col < g.n) {
        const size_t at = (size_t)row * g.n + col;
        if (g.residual) y = add_bf16x8(*reinterpret_cast<const uint4*>(g.residual + at), y);
        *reinterpret_cast<uint4*>(out + at) = y;
      }
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

// a (rows, k) bf16 matrix as a TMA map with 192 x 64 boxes
int gemm_map(CUtensorMap* map, const bf16* x, int rows, int k) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {kGK, kGM};
  return make_map(map, x, 2, dims, strides, box);
}

int launch_gemm(const Gemm<bf16>& g, int parts, cudaStream_t stream) {
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || g.n % 8 || g.k % 8) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGSmem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap ma, mw[3];
  int err = gemm_map(&ma, g.a, g.m, g.k);
  for (int z = 0; z < 3 && !err; ++z) err = gemm_map(&mw[z], g.w[z < parts ? z : 0], g.n, g.k);
  if (err) return err;
  const dim3 grid(parts * ((g.n + kGN - 1) / kGN), (g.m + kGM - 1) / kGM);
  gemm_bf16_kernel<<<grid, kGThreads, kGSmem, stream>>>(ma, mw[0], mw[1], mw[2], g);
  return (int)cudaGetLastError();
}

int launch_gemm(const Gemm<float>& g, int parts, cudaStream_t stream) {
  const dim3 grid((g.m + kFM - 1) / kFM, (g.n + kFN - 1) / kFN, parts);
  gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_layernorm(const T* x, const float* w, const float* b, T* y, int rows, int cols,
                     float eps, cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  layernorm_kernel<T><<<(rows + kLnRows - 1) / kLnRows, kThreads, 0, stream>>>(x, w, b, y, rows,
                                                                              cols, eps);
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

  int err = launch_layernorm(x, ln_w, ln_b, xn, m, channels, eps, stream);
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

extern "C" int prpe_ln_mhsa_f32(const void* x, const void* ln_w, const void* ln_b, const void* wq,
                                const void* bq, const void* wk, const void* bk, const void* wv,
                                const void* bv, const void* wo, const void* bo, void* out,
                                void* ws, int batch, int seq, int channels, int heads, float eps,
                                float scale, void* stream) {
  return ln_mhsa<float>((const float*)x, (const float*)ln_w, (const float*)ln_b,
                        (const float*)wq, (const float*)bq, (const float*)wk, (const float*)bk,
                        (const float*)wv, (const float*)bv, (const float*)wo, (const float*)bo,
                        (float*)out, (float*)ws, batch, seq, channels, heads, eps, scale,
                        (cudaStream_t)stream);
}

extern "C" int prpe_ln_mhsa_bf16(const void* x, const void* ln_w, const void* ln_b,
                                 const void* wq, const void* bq, const void* wk, const void* bk,
                                 const void* wv, const void* bv, const void* wo, const void* bo,
                                 void* out, void* ws, int batch, int seq, int channels,
                                 int heads, float eps, float scale, void* stream) {
  return ln_mhsa<bf16>((const bf16*)x, (const float*)ln_w, (const float*)ln_b, (const bf16*)wq,
                       (const float*)bq, (const bf16*)wk, (const float*)bk, (const bf16*)wv,
                       (const float*)bv, (const bf16*)wo, (const float*)bo, (bf16*)out,
                       (bf16*)ws, batch, seq, channels, heads, eps, scale, (cudaStream_t)stream);
}

// Stage 1 alone: y = LayerNorm(x) over rows of ``cols``, fp32 scale and shift.
extern "C" int prpe_layernorm_bf16(const void* x, const void* w, const void* b, void* y,
                                   int rows, int cols, float eps, void* stream) {
  return launch_layernorm((const bf16*)x, (const float*)w, (const float*)b, (bf16*)y, rows, cols,
                          eps, (cudaStream_t)stream);
}

// Stages 2 and 4 alone: out = round(a @ w^T + bias) (+ residual when not
// null), a (m, k), w (n, k), out and residual (m, n); k and n multiples of 8.
extern "C" int prpe_linear_bf16(const void* a, const void* w, const void* bias,
                                const void* residual, void* out, int m, int n, int k,
                                void* stream) {
  const bf16* wt = (const bf16*)w;
  const float* bt = (const float*)bias;
  bf16* ot = (bf16*)out;
  const Gemm<bf16> g{(const bf16*)a, {wt, wt, wt}, {bt, bt, bt}, {ot, ot, ot},
                     (const bf16*)residual, m, n, k};
  return launch_gemm(g, 1, (cudaStream_t)stream);
}
