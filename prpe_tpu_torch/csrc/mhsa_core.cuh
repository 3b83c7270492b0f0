// Multi-head self-attention device code, shared by mhsa.cu and ln_mhsa.cu.
//
// Per image and head: softmax(Q K^T * d^-1/2) V. Logits accumulate in fp32
// and are scaled after the dot product; the softmax is fp32; P is rounded to
// the input dtype before P V, which accumulates in fp32; the output is
// stored in the input dtype. These are the numerics of every attention body
// in prpe_tpu/ops/pallas/attention_kernel.py.
//
// Addressing: element d of token t, head h, image b sits at
// b * image + h * head + t * token + d (HeadStrides, in elements). The packed
// (B, T, H*D) layout is {T*C, D, C}; the (B, H, T, D) layout is {H*T*D, T*D, D}.
// One block per (query tile, head, image) either way.
//
// What bounds it on the H100: at the ViT-B shape (T = 192, H = 12, D = 64,
// bf16) a launch moves 4 * B*T*C*2 bytes and does 4*B*H*T^2*D FLOPs, about
// 96 FLOP per byte: below the bf16 tensor-core ridge, so the bound is bytes.
// The design keeps everything but q/k/v and the output on chip: a block
// stages its query tile in shared memory, streams keys and then values
// through one shared 64-row tile, and keeps the (tile x T) fp32 logits in
// shared memory for the softmax. The bf16 kernel computes both products on
// the tensor cores with WMMA 16x16x16 fragments; the fp32 kernel uses
// CUDA-core FMAs, since fp32 inputs have no tensor-core path of the same
// precision. The query tile is 64 rows when shared memory allows, else 32
// or 16.
//
// Each .cu file that includes this header is built into its own library,
// so the anonymous namespace gives every definition internal linkage there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

struct HeadStrides {
  long long image, head, token;
};

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeyTile = 64;
constexpr size_t kMaxSmem = 227 * 1024;

// ------------------------------------------------------------------ shared

// One warp per row: s[c] * scale for c < seq -> fp32 softmax; ``put(c, p)``
// receives each probability (rounded by the caller to the input dtype).
template <typename Put>
__device__ __forceinline__ void softmax_row(float* row, int seq, float scale, int lane, Put put) {
  float mx = -CUDART_INF_F;
  for (int c = lane; c < seq; c += 32) mx = fmaxf(mx, row[c] * scale);
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.0f;
  for (int c = lane; c < seq; c += 32) {
    const float e = expf(row[c] * scale - mx);
    row[c] = e;
    sum += e;
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  for (int c = lane; c < seq; c += 32) put(c, row[c] / sum);
}

// --------------------------------------------------- fp32: CUDA-core FMAs

constexpr int kMaxRows = 16;  // logits per thread per key tile: QT * 64 / 256
constexpr int kMaxOut = 32;   // outputs per thread: QT * D / 256

__global__ void __launch_bounds__(kThreads)
mhsa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                HeadStrides str, int seq, int dim, int qt, float scale) {
  extern __shared__ float smem[];
  const int kv_stride = dim + 1;  // padded rows: conflict-free column reads
  float* qs = smem;                        // qt x dim
  float* tile = qs + qt * dim;             // kKeyTile x (dim + 1), keys then values
  float* s = tile + kKeyTile * kv_stride;  // qt x seq logits, then probabilities

  const int t0 = blockIdx.x * qt;
  const int tid = threadIdx.x;
  const long long ts = str.token;
  const size_t base = (size_t)blockIdx.z * str.image + (size_t)blockIdx.y * str.head;

  for (int idx = tid; idx < qt * dim; idx += kThreads) {
    const int r = idx / dim, d = idx - r * dim;
    qs[idx] = t0 + r < seq ? q[base + (t0 + r) * ts + d] : 0.0f;
  }

  // logits: thread owns key column kc of the tile and rows r0 + 4m
  const int kc = tid % kKeyTile;
  const int r0 = tid / kKeyTile;
  const int n_rows = qt / (kThreads / kKeyTile);
  for (int kt = 0; kt < seq; kt += kKeyTile) {
    __syncthreads();
    for (int idx = tid; idx < kKeyTile * dim; idx += kThreads) {
      const int c = idx / dim, d = idx - c * dim;
      tile[c * kv_stride + d] = kt + c < seq ? k[base + (kt + c) * ts + d] : 0.0f;
    }
    __syncthreads();
    float acc[kMaxRows];
#pragma unroll
    for (int m = 0; m < kMaxRows; ++m) acc[m] = 0.0f;
    for (int d = 0; d < dim; ++d) {
      const float kv = tile[kc * kv_stride + d];
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        if (m < n_rows) acc[m] += qs[(r0 + 4 * m) * dim + d] * kv;
      }
    }
    if (kt + kc < seq) {
#pragma unroll
      for (int m = 0; m < kMaxRows; ++m) {
        if (m < n_rows) s[(r0 + 4 * m) * seq + kt + kc] = acc[m];
      }
    }
  }
  __syncthreads();

  const int lane = tid & 31;
  for (int r = tid >> 5; r < qt; r += kWarps) {
    float* row = s + (size_t)r * seq;
    softmax_row(row, seq, scale, lane, [&](int c, float p) { row[c] = p; });
  }

  // P V: thread owns output column od and rows orow0 + m * (256 / dim)
  const int od = tid % dim;
  const int orow0 = tid / dim;
  const int row_step = kThreads / dim;
  const int n_out = (qt * dim + kThreads - 1) / kThreads;
  float out[kMaxOut];
#pragma unroll
  for (int m = 0; m < kMaxOut; ++m) out[m] = 0.0f;
  for (int kt = 0; kt < seq; kt += kKeyTile) {
    __syncthreads();
    for (int idx = tid; idx < kKeyTile * dim; idx += kThreads) {
      const int c = idx / dim, d = idx - c * dim;
      tile[c * kv_stride + d] = kt + c < seq ? v[base + (kt + c) * ts + d] : 0.0f;
    }
    __syncthreads();
    const int nc = min(kKeyTile, seq - kt);
    for (int c = 0; c < nc; ++c) {
      const float vv = tile[c * kv_stride + od];
#pragma unroll
      for (int m = 0; m < kMaxOut; ++m) {
        const int r = orow0 + m * row_step;
        if (m < n_out && r < qt) out[m] += s[(size_t)r * seq + kt + c] * vv;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kMaxOut; ++m) {
    const int r = orow0 + m * row_step;
    if (m < n_out && r < qt && t0 + r < seq) o[base + (t0 + r) * ts + od] = out[m];
  }
}

size_t f32_smem(int qt, int seq, int dim) {
  return sizeof(float) * ((size_t)qt * dim + (size_t)kKeyTile * (dim + 1) + (size_t)qt * seq);
}

// --------------------------------------------------- bf16: tensor cores

constexpr int kMaxAccFrags = 4;  // P V fragments per warp: (64/16) * (128/16) / 8

__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

struct Bf16Layout {
  int tpad, ldq, lds, ldp, ldo;
  size_t off_kv, off_s, off_p, total;
  __host__ __device__ Bf16Layout(int qt, int seq, int dim) {
    tpad = (seq + kKeyTile - 1) / kKeyTile * kKeyTile;
    ldq = dim + 8;   // bf16 rows of q and of the key/value tile
    lds = tpad + 4;  // fp32 logits
    ldp = tpad + 8;  // bf16 probabilities
    ldo = dim + 4;   // fp32 output staging, aliased on the logits
    off_kv = round128((size_t)qt * ldq * sizeof(bf16));
    off_s = off_kv + round128((size_t)kKeyTile * ldq * sizeof(bf16));
    const size_t s_bytes = (size_t)qt * (lds > ldo ? lds : ldo) * sizeof(float);
    off_p = off_s + round128(s_bytes);
    total = off_p + round128((size_t)qt * ldp * sizeof(bf16));
  }
};

// rows [row0, row0 + n) of one head into shared rows of stride ld, zero
// past seq; 16-byte vectors (the wrappers check the alignment)
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src, size_t base,
                                          long long ts, int row0, int n, int seq, int dim,
                                          int tid) {
  const int vecs = dim / 8;
  for (int idx = tid; idx < n * vecs; idx += kThreads) {
    const int r = idx / vecs, c = idx - r * vecs;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < seq) val = *reinterpret_cast<const uint4*>(src + base + (row0 + r) * ts + c * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c * 8) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
mhsa_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 HeadStrides str, int seq, int dim, int qt, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Bf16Layout L(qt, seq, dim);
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv = reinterpret_cast<bf16*>(smem_raw + L.off_kv);
  float* s = reinterpret_cast<float*>(smem_raw + L.off_s);
  bf16* p = reinterpret_cast<bf16*>(smem_raw + L.off_p);

  const int t0 = blockIdx.x * qt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long ts = str.token;
  const size_t base = (size_t)blockIdx.z * str.image + (size_t)blockIdx.y * str.head;
  const int qf = qt / 16, df = dim / 16;

  load_rows(qs, L.ldq, q, base, ts, t0, qt, seq, dim, tid);

  // S = Q K^T, one 64-key tile at a time
  for (int kt = 0; kt < L.tpad; kt += kKeyTile) {
    __syncthreads();
    load_rows(kv, L.ldq, k, base, ts, kt, kKeyTile, seq, dim, tid);
    __syncthreads();
    for (int f = warp; f < qf * (kKeyTile / 16); f += kWarps) {
      const int fr = f / (kKeyTile / 16), fc = f % (kKeyTile / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < df; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + fr * 16 * L.ldq + kk * 16, L.ldq);
        wmma::load_matrix_sync(b, kv + fc * 16 * L.ldq + kk * 16, L.ldq);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s + fr * 16 * L.lds + kt + fc * 16, acc, L.lds, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // fp32 softmax of the scaled logits; P rounded to bf16, zero past seq
  for (int r = warp; r < qt; r += kWarps) {
    bf16* prow = p + (size_t)r * L.ldp;
    softmax_row(s + (size_t)r * L.lds, seq, scale, lane,
                [&](int c, float val) { prow[c] = __float2bfloat16_rn(val); });
    for (int c = seq + lane; c < L.tpad; c += 32) prow[c] = __float2bfloat16_rn(0.0f);
  }

  // O = P V, accumulated over the value tiles in fragments held per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> out[kMaxAccFrags];
#pragma unroll
  for (int m = 0; m < kMaxAccFrags; ++m) wmma::fill_fragment(out[m], 0.0f);
  for (int kt = 0; kt < L.tpad; kt += kKeyTile) {
    __syncthreads();
    load_rows(kv, L.ldq, v, base, ts, kt, kKeyTile, seq, dim, tid);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kMaxAccFrags; ++m) {
      const int f = warp + m * kWarps;
      if (f < qf * df) {
        const int fr = f / df, fc = f % df;
        for (int kk = 0; kk < kKeyTile / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, p + fr * 16 * L.ldp + kt + kk * 16, L.ldp);
          wmma::load_matrix_sync(b, kv + kk * 16 * L.ldq + fc * 16, L.ldq);
          wmma::mma_sync(out[m], a, b, out[m]);
        }
      }
    }
  }
  __syncthreads();  // the logits are dead: stage the output over them
#pragma unroll
  for (int m = 0; m < kMaxAccFrags; ++m) {
    const int f = warp + m * kWarps;
    if (f < qf * df) {
      const int fr = f / df, fc = f % df;
      wmma::store_matrix_sync(s + fr * 16 * L.ldo + fc * 16, out[m], L.ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < qt * dim; idx += kThreads) {
    const int r = idx / dim, d = idx - r * dim;
    if (t0 + r < seq) o[base + (t0 + r) * ts + d] = __float2bfloat16_rn(s[r * L.ldo + d]);
  }
}

// ------------------------------------------------------------------ launch

template <typename Smem>
int pick_tile(Smem smem) {
  int qt = 64;
  while (qt > 16 && smem(qt) > kMaxSmem) qt /= 2;
  return smem(qt) > kMaxSmem ? 0 : qt;
}

bool bad_shape(int batch, int seq, int heads, int dim) {
  return batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
         (dim != 16 && dim != 32 && dim != 64 && dim != 128);
}

// One attention launch over q/k/v/o laid out by ``str``, on ``stream``;
// returns the CUDA error code (0 on success).
int launch_mhsa(const float* q, const float* k, const float* v, float* o, HeadStrides str,
                int batch, int seq, int heads, int dim, float scale, cudaStream_t stream) {
  if (bad_shape(batch, seq, heads, dim)) return (int)cudaErrorInvalidValue;
  const int qt = pick_tile([&](int t) { return f32_smem(t, seq, dim); });
  if (qt == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = f32_smem(qt, seq, dim);
  cudaError_t err = cudaFuncSetAttribute(mhsa_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + qt - 1) / qt, heads, batch);
  mhsa_f32_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, str, seq, dim, qt, scale);
  return (int)cudaGetLastError();
}

int launch_mhsa(const bf16* q, const bf16* k, const bf16* v, bf16* o, HeadStrides str,
                int batch, int seq, int heads, int dim, float scale, cudaStream_t stream) {
  if (bad_shape(batch, seq, heads, dim)) return (int)cudaErrorInvalidValue;
  const int qt = pick_tile([&](int t) { return Bf16Layout(t, seq, dim).total; });
  if (qt == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Bf16Layout(qt, seq, dim).total;
  cudaError_t err = cudaFuncSetAttribute(mhsa_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + qt - 1) / qt, heads, batch);
  mhsa_bf16_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, str, seq, dim, qt, scale);
  return (int)cudaGetLastError();
}

HeadStrides packed_strides(int seq, int heads, int dim) {
  const long long c = (long long)heads * dim;
  return {seq * c, dim, c};
}

}  // namespace
