// Multi-head self-attention device code, shared by mhsa.cu and ln_mhsa.cu.
//
// Replaces the attention of every Pallas body in
// prpe_tpu/ops/pallas/attention_kernel.py: _mhsa_kernel_packed (K2, through
// mhsa.cu's packed entry points), _mhsa_kernel_batched, _mhsa_kernel and
// _mhsa_kernel_bh (K3a-c, through its (B, H, T, D) entry points) and the
// attention stage of _ln_mhsa_kernel (K4, through ln_mhsa.cu).
//
// Per image and head: softmax(Q K^T * d^-1/2) V, with the numerics of those
// bodies: logits accumulate in fp32 and are scaled after the dot product;
// the softmax is fp32 over the whole row, expf(s * scale - max) divided by
// the row sum; P is normalised and only then rounded to the input dtype;
// P V accumulates in fp32; the output is rounded once.
//
// Addressing: element d of token t, head h, image b sits at
// b * image + h * head + t * token + d (HeadStrides, in elements). The packed
// (B, T, H*D) layout is {T*C, D, C}; the (B, H, T, D) layout is {H*T*D, T*D, D}.
//
// What bounds it on the H100: at the ViT-B shape (T = 192, H = 12, D = 64,
// bf16) a launch moves 4 * B*T*C*2 bytes and does 4*B*H*T^2*D FLOPs, about
// 96 FLOP per byte: below the bf16 tensor-core ridge (about 295), so the
// bound is bytes, and the time goes to latency unless loads overlap work.
//
// The bf16 design for Hopper (hopper.cuh has the primitives): one warpgroup
// (128 threads) per (64-query tile, head, image), three blocks an SM.
//   - Loads are asynchronous: one thread issues TMA boxes (64 tokens of one
//     head, swizzled) for the query tile and the head's keys on one
//     mbarrier and for its values on a second, so Q K^T starts while V is
//     still in flight. Tokens past T arrive as zeros. The three tensor maps
//     are encoded on the host at each launch.
//   - S = Q K^T runs on wgmma (m64n64k16, both operands K-major in shared
//     memory); for T <= kRegKeys (192) the whole (64 x T) fp32 row block
//     stays in registers (96 a thread at T = 192).
//   - The softmax reduces each row's max and sum across the four threads of
//     a quad with shuffles, normalises, and rounds P to bf16 in registers.
//     Each quotient is the IEEE one, formed from the row's reciprocal with an
//     FMA correction (div_by). Between two chip_smoke.py runs whose
//     attention differed in that alone, K2 at B = 32 went from 0.0399 to
//     0.0320 ms (NVIDIA H100 80GB HBM3, 700.00 W).
//   - O = P V runs on wgmma with A from registers (the accumulator layout is
//     the A-fragment layout) and V MN-major in shared memory: neither the
//     logits nor P touch shared memory.
//   - The fp32 accumulator is rounded once; quads exchange values so each
//     thread stores 16-byte vectors (no staging pass through shared memory).
// Longer sequences (T > 192, up to the wrappers' MAX_T) take a streaming
// kernel of the same pieces over double-buffered 64-key tiles in two passes:
// the row max and sum, then each logits tile again, normalised, rounded and
// multiplied by its value tile. Both keep the normalise-then-round order.
//
// The fp32 kernel (K2/K3 in fp32 and K4's fp32 attention stage) stays in
// fp32 on CUDA-core FMAs: fp32 has no tensor-core path of the same
// precision (TF32 keeps 10 mantissa bits), expf is the accurate one and each
// quotient the IEEE one (div_by). At the ViT-B shape a launch does 4*B*H*T^2*D
// FLOPs against 4 * B*T*C*4 bytes, about 48 FLOP per byte: far above the
// fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 FLOP per byte), so the bound is
// the FMA rate. What holds it back is the shared-memory pipe: a 16-byte
// shared load takes four cycles of it whatever it broadcasts, so a thread
// tile of a x b outputs runs at the FMA rate only if ab / (a + b) >= 4. The
// design for Hopper:
//   - 256 threads per (64-query tile, head, image) as a 16 x 16 grid; a
//     thread owns query rows ty + 16 i (i < 4) and, in Q K^T, the keys
//     tx + 16 j (j < 12) of a 192-key chunk: 48 logits in registers
//     (4 x 12: ab / (a + b) = 3). Q and K sit row-major in shared memory,
//     16-byte chunks swizzled by row, so one float4 load of a key row feeds
//     16 FMAs and one of a query row 48; the 16 threads of a row are half a
//     warp, so the row max and sum are four shuffles each. (An 8 x 6 tile,
//     one warp a row, spilled and ran slower.)
//   - P, normalised in registers, is written once into the key buffer
//     (the keys are dead by then), rows kPStride floats apart. P V splits
//     the chunk's keys among G groups of threads (4 at D = 64), so that a
//     thread owns 8 rows x 8 head-dim columns (ab / (a + b) = 4): per four
//     keys, eight float4 loads of P and eight of V feed 256 FMAs, each load
//     one wavefront at an immediate offset from one pointer (V is not
//     swizzled: the chunks a warp reads are neighbours in one row). The
//     groups' partial tiles are then summed through shared memory, in group
//     order, by threads that store neighbouring chunks of a row.
//   - Q with the keys, then the values, are copied with cp.async in two
//     groups, so Q K^T starts while V is still in flight; 113 KB of shared
//     memory at D = 64 lets two blocks share an SM, one loading while the
//     other computes.
//   - T > 192 (up to the wrappers' MAX_T) runs two passes over the chunks:
//     the row max and sum of exp (rescaled as the max grows), then each
//     chunk's logits again, normalised, times its values.
//   Measured at B = 32 (tools/variants.py, NVIDIA H100 80GB HBM3 at
//   700 W): removing P V takes the kernel from 0.1152 to 0.0766 ms; at the
//   FMA rate each product would take 0.027 ms.
// The shared-memory limit and carve-out are set once per head dim.
//
// Each .cu file that includes this header is built into its own library,
// so the anonymous namespace gives every definition internal linkage there.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

struct HeadStrides {
  long long image, head, token;
};

constexpr int kThreads = 256;  // fp32 attention, and ln_mhsa.cu's LayerNorm and fp32 GEMM
constexpr int kKeyTile = 64;

// a / b for 0 <= a <= b, b >= 1, given r = 1.0f / b: q = a * r with one FMA
// correction. With r the correctly rounded reciprocal, this is the correctly
// rounded quotient that IEEE division gives (Markstein), at three
// instructions for each of a row's many quotients.
__device__ __forceinline__ float div_by(float a, float b, float r) {
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

// --------------------------------------------------- fp32: CUDA-core FMAs

constexpr int kFRows = 64;   // query rows of a block
constexpr int kFKeys = 192;  // keys of a chunk: 12 a thread, 16 threads a row

// 16 bytes from global to shared memory, asynchronously; zeros unless ``full``
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kPStride = kFKeys + 4;  // floats per row of P: 4 rows in 4 bank groups

// Shared-memory geometry of the fp32 kernel for head dim D, in floats: the
// query tile and the key chunk, row-major with 16-byte chunk c of row r at
// c ^ (r & SWZ); the chunk's probabilities in the keys' place, rows
// kPStride apart; the value chunk row-major (P V reads eight neighbouring
// chunks of one row: one wavefront without a swizzle).
template <int D>
struct F32Tile {
  static constexpr int CH = D / 4;
  static constexpr int SWZ = (CH < 8 ? CH : 8) - 1;
  static constexpr int Q = kFRows * D;
  static constexpr int KP = kFKeys * D > kFRows * kPStride ? kFKeys * D : kFRows * kPStride;
  static constexpr int V = kFKeys * D;
  static constexpr size_t SMEM = sizeof(float) * (Q + KP + V);
  // P V: a thread owns 8 rows x 2 head-dim chunks; a group of 8 x PC
  // threads covers the 64 x D tile over its G-th of the chunk's keys
  static constexpr int PC = CH / 2;
  static constexpr int G = kThreads / (8 * PC);
  static constexpr int KG = kFKeys / G;
  // the groups' partial tiles, rows RS floats apart, over the whole buffer
  static constexpr int RS = D >= 32 ? D + 4 : D;
  static_assert(G * kFRows * RS <= Q + KP + V, "partial tiles fit in shared memory");
  // two blocks an SM where two fit in its 228 KB (1 KB reserved per block)
  static constexpr int BLOCKS = 2 * (SMEM + 1024) <= 228 * 1024 ? 2 : 1;
};

template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & F32Tile<D>::SWZ)) << 2);
}

// rows [t0, t0 + rows) of one head into a tile, swizzled or plain; rows
// past seq as zeros
template <int D, bool kSwizzle = true>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long ts, int t0,
                                          int rows, int seq) {
  constexpr int CH = D / 4;
  for (int idx = threadIdx.x; idx < rows * CH; idx += kThreads) {
    const int r = idx / CH, c = idx - r * CH;
    const bool in = t0 + r < seq;
    cp_async16(dst + (kSwizzle ? swz<D>(r, c) : r * D + 4 * c),
               src + (in ? (t0 + r) * ts + 4 * c : 0), in);
  }
}

// s[i][j] = q(row ty + 16 i) . k(key tx + 16 j of the chunk), summed over d in order
template <int D>
__device__ __forceinline__ void chunk_logits(float (&s)[4][12], const float* qs, const float* ks,
                                             int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) s[i][j] = 0.0f;
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    float4 qv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + swz<D>(ty + 16 * i, c));
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + swz<D>(tx + 16 * j, c));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = fmaf(qv[i].x, kv.x, s[i][j]);
        a = fmaf(qv[i].y, kv.y, a);
        a = fmaf(qv[i].z, kv.z, a);
        s[i][j] = fmaf(qv[i].w, kv.w, a);
      }
    }
  }
}

// scaled logits; keys k0 + tx + 16 j past seq at -inf
__device__ __forceinline__ void chunk_scale(float (&s)[4][12], int k0, int seq, float scale,
                                            int tx) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const bool in = k0 + tx + 16 * j < seq;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][j] = in ? s[i][j] * scale : -CUDART_INF_F;
  }
}

// over the 16 lanes of a row (one half warp)
__device__ __forceinline__ float row_max(const float (&x)[12]) {
  float m = x[0];
#pragma unroll
  for (int j = 1; j < 12; ++j) m = fmaxf(m, x[j]);
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// kStream: T > kFKeys, in two passes over the key chunks, one block an SM
// (the row statistics and the output stay in registers across chunks);
// else one chunk, two blocks an SM where shared memory allows.
template <int D, bool kStream>
__global__ void __launch_bounds__(kThreads, kStream ? 1 : F32Tile<D>::BLOCKS)
mhsa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, HeadStrides str, int seq,
                float scale) {
  using T = F32Tile<D>;
  extern __shared__ float4 smem_f32[];
  float* qs = reinterpret_cast<float*>(smem_f32);
  float* ks = qs + T::Q;  // a chunk's keys, then its probabilities
  float* vs = ks + T::KP;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // in P V, thread (g, pr, pc) owns rows pr + 8 i (i < 8) and head-dim
  // chunks pc and pc + PC over keys [g KG, g KG + KG) of each chunk
  const int pc = tid % T::PC, pr = (tid / T::PC) & 7, g = tid / (8 * T::PC);
  const int t0 = blockIdx.x * kFRows;
  const size_t base = (size_t)blockIdx.z * str.image + (size_t)blockIdx.y * str.head;
  const long long ts = str.token;
  const int nch = kStream ? (seq + kFKeys - 1) / kFKeys : 1;
  float s[4][12], m[4], l[4];

  load_rows<D>(qs, q + base, ts, t0, kFRows, seq);  // completes with the first key chunk
  if constexpr (kStream) {
    // pass 1: each row's max m and sum l of exp(s - m), rescaled as m grows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.0f;
    }
    for (int ch = 0; ch < nch; ++ch) {
      if (ch) __syncthreads();  // every thread is done with the last chunk's keys
      load_rows<D>(ks, k + base, ts, ch * kFKeys, kFKeys, seq);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      chunk_logits<D>(s, qs, ks, tx, ty);
      chunk_scale(s, ch * kFKeys, seq, scale, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float mn = fmaxf(m[i], row_max(s[i]));
        float e = 0.0f;
#pragma unroll
        for (int j = 0; j < 12; ++j) e += expf(s[i][j] - mn);
        l[i] = l[i] * expf(m[i] - mn) + row_sum(e);
        m[i] = mn;
      }
    }
    __syncthreads();
  }

  // pass 2 (the only one without kStream): P of each chunk, then O += P V
  float acc[8][2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;
  for (int ch = 0; ch < nch; ++ch) {
    const int k0 = ch * kFKeys;
    if (ch) __syncthreads();  // every thread is done with the last chunk's P and V
    load_rows<D>(ks, k + base, ts, k0, kFKeys, seq);
    cp_async_commit();
    load_rows<D, false>(vs, v + base, ts, k0, kFKeys, seq);
    cp_async_commit();
    cp_async_wait<1>();  // Q and the keys; the values may still be in flight
    __syncthreads();
    chunk_logits<D>(s, qs, ks, tx, ty);
    chunk_scale(s, k0, seq, scale, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (!kStream) {
        m[i] = row_max(s[i]);
        float e = 0.0f;
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          s[i][j] = expf(s[i][j] - m[i]);
          e += s[i][j];
        }
        l[i] = row_sum(e);
      } else {
#pragma unroll
        for (int j = 0; j < 12; ++j) s[i][j] = expf(s[i][j] - m[i]);
      }
      const float r = 1.0f / l[i];
#pragma unroll
      for (int j = 0; j < 12; ++j) s[i][j] = div_by(s[i][j], l[i], r);
    }
    __syncthreads();  // every thread is done with the keys: P takes their place
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j)
        ks[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
    cp_async_wait<0>();
    __syncthreads();
    // keys past seq have P = 0 and zero values, so the loop may round up to 4
    const int c1 = min(g * T::KG + T::KG, seq - k0);
    // one base pointer each for P and V: every load below has an immediate
    // offset from it
    const float* prow = ks + pr * kPStride;
    const float* vcol = vs + 4 * pc;
#pragma unroll 2
    for (int c = g * T::KG; c < c1; c += 4) {
      float4 p[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        p[i] = *reinterpret_cast<const float4*>(prow + 8 * i * kPStride + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float4 vv = *reinterpret_cast<const float4*>(vcol + (c + e) * D + 4 * n * T::PC);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y : e == 2 ? p[i].z : p[i].w;
            acc[i][n][0] = fmaf(pe, vv.x, acc[i][n][0]);
            acc[i][n][1] = fmaf(pe, vv.y, acc[i][n][1]);
            acc[i][n][2] = fmaf(pe, vv.z, acc[i][n][2]);
            acc[i][n][3] = fmaf(pe, vv.w, acc[i][n][3]);
          }
        }
      }
    }
  }
  // the groups' partial tiles through shared memory, summed in group order
  __syncthreads();  // every thread is done with Q, P and V
  float* part = qs;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      *reinterpret_cast<float4*>(part + (g * kFRows + pr + 8 * i) * T::RS + 4 * (pc + n * T::PC)) =
          make_float4(acc[i][n][0], acc[i][n][1], acc[i][n][2], acc[i][n][3]);
  __syncthreads();
  // each pass a row of chunks per CH threads: neighbouring threads read
  // neighbouring chunks of one row and store them coalesced
  constexpr int kRowsPerPass = kThreads / T::CH;
  const int c = 4 * (tid % T::CH);
#pragma unroll
  for (int r = tid / T::CH; r < kFRows; r += kRowsPerPass) {
    float4 sum = *reinterpret_cast<const float4*>(part + r * T::RS + c);
#pragma unroll
    for (int h = 1; h < T::G; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(part + (h * kFRows + r) * T::RS + c);
      sum = make_float4(sum.x + x.x, sum.y + x.y, sum.z + x.z, sum.w + x.w);
    }
    if (t0 + r < seq) *reinterpret_cast<float4*>(o + base + (t0 + r) * ts + c) = sum;
  }
}

// ------------------------------------------------ bf16: wgmma, Hopper only

constexpr int kWg = 128;      // threads: one warpgroup
constexpr int kQTile = 64;    // query rows per block: one wgmma M
constexpr int kRegTiles = 3;  // 64-key logits tiles held in registers
constexpr int kRegKeys = kRegTiles * kKeyTile;

// Shared-memory geometry of a head dimension D: TMA boxes of 64 rows, each
// row ``span`` bytes (at most 64 values); D = 128 takes two column blocks.
template <int D>
struct Tiles {
  static constexpr int SPAN = D >= 64 ? 128 : 2 * D;
  static constexpr int NB = D > 64 ? 2 : 1;
  static constexpr int BOX = kKeyTile * SPAN;  // bytes of one box (== kQTile rows)
  static constexpr int STEPS = SPAN / 32;      // k16 steps of Q K^T in one column block
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Rows [t0, t0 + 64) of head h, image b from a head map into ``dst`` (column
// block cb at dst + cb * cb_bytes), completing on bar. The map's dimensions
// are (D, H, T, B) when heads are inner to tokens (packed), else (D, T, H, B).
template <int D>
__device__ __forceinline__ void load_head_rows(unsigned char* dst, int cb_bytes,
                                               const CUtensorMap* map, bool heads_inner, int t0,
                                               int h, int b, uint64_t* bar) {
#pragma unroll
  for (int cb = 0; cb < Tiles<D>::NB; ++cb)
    tma_load(dst + cb * cb_bytes, map, cb * 64, heads_inner ? h : t0, heads_inner ? t0 : h, b,
             bar);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// s = Q K^T for one 64-key tile: qs and ks hold NB column blocks, BOX apart
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[32], const unsigned char* qs,
                                        const unsigned char* ks) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cb = kk / T::STEPS, j = kk % T::STEPS;
    wgmma_ss<64>(s, desc_k(qs + cb * T::BOX, T::SPAN, 0, j),
                 desc_k(ks + cb * T::BOX, T::SPAN, 0, j));
  }
}

// Logits of the 64-key tile at key k0: scaled, -inf past seq. Element v of
// the accumulator is key k0 + 8 (v / 4) + 2 quad + v % 2 of row half (v / 2) % 2.
__device__ __forceinline__ void scale_mask(float (&s)[32], int k0, int seq, float scale, int quad) {
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    const int key = k0 + (v >> 2) * 8 + 2 * quad + (v & 1);
    s[v] = key < seq ? s[v] * scale : -CUDART_INF_F;
  }
}

__device__ __forceinline__ void tile_max(const float (&s)[32], float (&mx)[2]) {
#pragma unroll
  for (int v = 0; v < 32; ++v) mx[(v >> 1) & 1] = fmaxf(mx[(v >> 1) & 1], s[v]);
}

// exp(s - max) in place; adds each row half's terms to sum
__device__ __forceinline__ void tile_exp(float (&s)[32], const float (&mx)[2], float (&sum)[2]) {
#pragma unroll
  for (int v = 0; v < 32; ++v) {
    s[v] = expf(s[v] - mx[(v >> 1) & 1]);
    sum[(v >> 1) & 1] += s[v];
  }
}

// e / sum rounded to bf16, as the A operands of the tile's four k16 steps
__device__ __forceinline__ void tile_p(const float (&e)[32], const float (&sum)[2],
                                       uint32_t (&p)[4][4]) {
  const float r[2] = {1.0f / sum[0], 1.0f / sum[1]};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float b = sum[i & 1], ri = r[i & 1];
      p[kk][i] = pack_bf16(div_by(e[8 * kk + 2 * i], b, ri), div_by(e[8 * kk + 2 * i + 1], b, ri));
    }
}

// o += P V for one 64-key tile: vs is its first row in an MN-major tile
// whose column blocks are cb_bytes apart
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], const uint32_t (&p)[4][4],
                                        const unsigned char* vs, int cb_bytes) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_mn<D>(o, p[kk], desc_mn(vs, Tiles<D>::SPAN, cb_bytes, kk));
}

// The warpgroup's 64 x D accumulator, rounded once, to rows [t0, t0 + 64)
// (those < seq) of the head at o; 16-byte stores where D allows.
template <int D>
__device__ __forceinline__ void store_tile(bf16* o, long long ts, int t0, int seq,
                                           const float (&acc)[D / 2], int tid) {
  const int lane = tid & 31, quad = lane & 3;
  const int r = t0 + (tid >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if constexpr (D % 32 == 0) {
#pragma unroll
      for (int g = 0; g < D / 32; ++g) {
        const int a = 16 * g + 2 * h;  // blocks 4g .. 4g + 3 of row half h
        const uint4 w = quad_gather(pack_bf16(acc[a], acc[a + 1]), pack_bf16(acc[a + 4], acc[a + 5]),
                                    pack_bf16(acc[a + 8], acc[a + 9]),
                                    pack_bf16(acc[a + 12], acc[a + 13]), quad);
        if (row < seq) *reinterpret_cast<uint4*>(o + row * ts + 32 * g + 8 * quad) = w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (row < seq) {
          *reinterpret_cast<uint32_t*>(o + row * ts + 8 * j + 2 * quad) =
              pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// T <= kRegKeys: the head's keys and values resident, logits in registers.
// Shared memory: the query tile, three 64-row key tiles (K-major), then the
// 192 value rows of each column block (MN-major). Keys past seq arrive as
// zeros and are masked; every block runs all three key tiles, so no wgmma
// sits on a divergent path (short sequences, off the ViT-B path, pay for
// the padding).
template <int D>
__global__ void __launch_bounds__(kWg, 3)
mhsa_bf16_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o, HeadStrides str,
                 int heads_inner, int seq, float scale) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar[2];  // Q and K; V
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + T::NB * T::BOX;
  unsigned char* vs = ks + kRegTiles * T::NB * T::BOX;
  const int tid = threadIdx.x, quad = tid & 3;
  const int t0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
  }
  mbar_init_visible();
  if (tid == 0) {
    mbar_expect(&bar[0], (1 + kRegTiles) * T::NB * T::BOX);
    load_head_rows<D>(qs, T::BOX, &mq, heads_inner, t0, h, b, &bar[0]);
#pragma unroll
    for (int t = 0; t < kRegTiles; ++t)
      load_head_rows<D>(ks + t * T::NB * T::BOX, T::BOX, &mk, heads_inner, t * kKeyTile, h, b,
                        &bar[0]);
    mbar_expect(&bar[1], kRegTiles * T::NB * T::BOX);
#pragma unroll
    for (int t = 0; t < kRegTiles; ++t)
      load_head_rows<D>(vs + t * T::BOX, kRegTiles * T::BOX, &mv, heads_inner, t * kKeyTile, h,
                        b, &bar[1]);
  }

  float s[kRegTiles][32];
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) s[t][i] = 0.0f;
  mbar_wait(&bar[0], 0);
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) fence_regs(s[t]);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) qk_tile<D>(s[t], qs, ks + t * T::NB * T::BOX);
  wgmma_commit();
  wgmma_wait<0>();

  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F}, sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) {
    fence_regs(s[t]);
    scale_mask(s[t], t * kKeyTile, seq, scale, quad);
    tile_max(s[t], mx);
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) tile_exp(s[t], mx, sum);
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  uint32_t p[kRegTiles][4][4];
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) tile_p(s[t], sum, p[t]);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  mbar_wait(&bar[1], 0);
  fence_regs(acc);
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) fence_regs(p[t]);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < kRegTiles; ++t) pv_tile<D>(acc, p[t], vs + t * T::BOX, kRegTiles * T::BOX);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const size_t base = (size_t)b * str.image + (size_t)h * str.head;
  store_tile<D>(o + base, str.token, t0, seq, acc, tid);
}

// T > kRegKeys: 64-key tiles stream through two buffers, in two passes (row
// max and sum over the key tiles; then each logits tile again, normalised,
// times its value tile). Buffer i holds a key tile and a value tile; its
// barrier completes once per fill, so each thread tracks one phase bit per
// buffer.
template <int D>
__global__ void __launch_bounds__(kWg, 3)
mhsa_bf16_stream_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                        HeadStrides str, int heads_inner, int seq, float scale) {
  using T = Tiles<D>;
  constexpr int TILE = T::NB * T::BOX;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar[3];  // Q; buffers 0 and 1
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ks = qs + TILE;      // two key tiles
  unsigned char* vs = ks + 2 * TILE;  // two value tiles
  const int nt = (seq + kKeyTile - 1) / kKeyTile;
  const int tid = threadIdx.x, quad = tid & 3;
  const int t0 = blockIdx.x * kQTile, h = blockIdx.y, b = blockIdx.z;
  uint32_t phase = 0;
  auto wait_buf = [&](int i) {
    mbar_wait(&bar[1 + i], (phase >> i) & 1);
    phase ^= 1u << i;
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i]);
  }
  mbar_init_visible();
  if (tid == 0) {
    mbar_expect(&bar[0], TILE);
    load_head_rows<D>(qs, T::BOX, &mq, heads_inner, t0, h, b, &bar[0]);
    mbar_expect(&bar[1], TILE);
    load_head_rows<D>(ks, T::BOX, &mk, heads_inner, 0, h, b, &bar[1]);
  }
  mbar_wait(&bar[0], 0);

  // pass 1: running row max m and sum l of exp(s - m)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};
  for (int t = 0; t < nt; ++t) {
    const int i = t & 1;
    wait_buf(i);
    __syncthreads();  // every thread is done with tile t - 1's buffer
    if (tid == 0 && t + 1 < nt) {
      mbar_expect(&bar[2 - i], TILE);
      load_head_rows<D>(ks + (1 - i) * TILE, T::BOX, &mk, heads_inner, (t + 1) * kKeyTile, h, b,
                        &bar[2 - i]);
    }
    float s[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) s[v] = 0.0f;
    fence_regs(s);
    wgmma_fence();
    qk_tile<D>(s, qs, ks + i * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    scale_mask(s, t * kKeyTile, seq, scale, quad);
    float mn[2] = {m[0], m[1]};
    tile_max(s, mn);
    mn[0] = quad_max(mn[0]);
    mn[1] = quad_max(mn[1]);
    l[0] *= expf(m[0] - mn[0]);
    l[1] *= expf(m[1] - mn[1]);
    tile_exp(s, mn, l);
    m[0] = mn[0];
    m[1] = mn[1];
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);

  // pass 2: each logits tile again, normalised and rounded, times its values
  __syncthreads();  // every thread is done with pass 1's key buffers
  if (tid == 0) {
    mbar_expect(&bar[1], 2 * TILE);
    load_head_rows<D>(ks, T::BOX, &mk, heads_inner, 0, h, b, &bar[1]);
    load_head_rows<D>(vs, T::BOX, &mv, heads_inner, 0, h, b, &bar[1]);
  }
  float acc[D / 2];
#pragma unroll
  for (int v = 0; v < D / 2; ++v) acc[v] = 0.0f;
  for (int t = 0; t < nt; ++t) {
    const int i = t & 1;
    wait_buf(i);
    __syncthreads();
    if (tid == 0 && t + 1 < nt) {
      const int k0 = (t + 1) * kKeyTile;
      mbar_expect(&bar[2 - i], 2 * TILE);
      load_head_rows<D>(ks + (1 - i) * TILE, T::BOX, &mk, heads_inner, k0, h, b, &bar[2 - i]);
      load_head_rows<D>(vs + (1 - i) * TILE, T::BOX, &mv, heads_inner, k0, h, b, &bar[2 - i]);
    }
    float s[32];
#pragma unroll
    for (int v = 0; v < 32; ++v) s[v] = 0.0f;
    fence_regs(s);
    wgmma_fence();
    qk_tile<D>(s, qs, ks + i * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    scale_mask(s, t * kKeyTile, seq, scale, quad);
    float unused[2] = {0.0f, 0.0f};
    tile_exp(s, m, unused);
    uint32_t p[4][4];
    tile_p(s, l, p);
    fence_regs(p);
    wgmma_fence();
    pv_tile<D>(acc, p, vs + i * TILE, T::BOX);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_regs(acc);
  const size_t base = (size_t)b * str.image + (size_t)h * str.head;
  store_tile<D>(o + base, str.token, t0, seq, acc, tid);
}

// ------------------------------------------------------------------ launch

bool bad_shape(int batch, int seq, int heads, int dim) {
  return batch <= 0 || seq <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
         (dim != 16 && dim != 32 && dim != 64 && dim != 128);
}

// the opt-in to more than 48 KB of shared memory and the largest carve-out
template <typename Kernel>
cudaError_t f32_attributes(Kernel kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e;
}

template <int D>
int launch_mhsa_f32(const float* q, const float* k, const float* v, float* o, HeadStrides str,
                    int batch, int seq, int heads, float scale, cudaStream_t stream) {
  constexpr size_t smem = F32Tile<D>::SMEM;
  static const cudaError_t attr = [] {  // once per kernel
    const cudaError_t e = f32_attributes(mhsa_f32_kernel<D, false>, smem);
    return e == cudaSuccess ? f32_attributes(mhsa_f32_kernel<D, true>, smem) : e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + kFRows - 1) / kFRows, heads, batch);
  if (seq <= kFKeys)
    mhsa_f32_kernel<D, false><<<grid, kThreads, smem, stream>>>(q, k, v, o, str, seq, scale);
  else
    mhsa_f32_kernel<D, true><<<grid, kThreads, smem, stream>>>(q, k, v, o, str, seq, scale);
  return (int)cudaGetLastError();
}

// One attention launch over q/k/v/o laid out by ``str``, on ``stream``;
// returns the CUDA error code (0 on success). q, k, v and o start on 16-byte
// boundaries, and every token and head offset is a multiple of 4 elements.
int launch_mhsa(const float* q, const float* k, const float* v, float* o, HeadStrides str,
                int batch, int seq, int heads, int dim, float scale, cudaStream_t stream) {
  if (bad_shape(batch, seq, heads, dim)) return (int)cudaErrorInvalidValue;
  switch (dim) {
    case 16: return launch_mhsa_f32<16>(q, k, v, o, str, batch, seq, heads, scale, stream);
    case 32: return launch_mhsa_f32<32>(q, k, v, o, str, batch, seq, heads, scale, stream);
    case 64: return launch_mhsa_f32<64>(q, k, v, o, str, batch, seq, heads, scale, stream);
    default: return launch_mhsa_f32<128>(q, k, v, o, str, batch, seq, heads, scale, stream);
  }
}

// shared memory of a bf16 kernel holding ``boxes`` 64-row tiles of every
// column block, with room to align it to 1024 bytes
template <int D>
constexpr size_t bf16_smem(int boxes) {
  return (size_t)boxes * Tiles<D>::NB * Tiles<D>::BOX + 1024;
}

// A 4-D TMA map of one of q/k/v: (D, H, T, B) when heads are inner to tokens
// (the packed layout), else (D, T, H, B), so that strides increase; boxes
// of 64 tokens of one head, at most 64 values wide.
int head_map(CUtensorMap* map, const bf16* x, HeadStrides str, int batch, int seq, int heads,
             int dim) {
  const bool inner = str.head < str.token;
  const cuuint64_t dims[4] = {(cuuint64_t)dim, (cuuint64_t)(inner ? heads : seq),
                              (cuuint64_t)(inner ? seq : heads), (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)(inner ? str.head : str.token) * 2,
                           (cuuint64_t)(inner ? str.token : str.head) * 2,
                           (cuuint64_t)str.image * 2};
  // a dimension of size 1 is never stepped: give it the stride of a dense
  // tensor, so the strides stay nondecreasing
  if (dims[1] == 1) strides[0] = (cuuint64_t)dim * 2;
  if (dims[2] == 1) strides[1] = strides[0] * dims[1];
  if (dims[3] == 1) strides[2] = strides[1] * dims[2];
  const cuuint32_t box[4] = {(cuuint32_t)(dim < 64 ? dim : 64), inner ? 1u : (cuuint32_t)kKeyTile,
                             inner ? (cuuint32_t)kKeyTile : 1u, 1};
  return make_map(map, x, 4, dims, strides, box);
}

template <int D>
int launch_mhsa_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o, HeadStrides str,
                     int batch, int seq, int heads, float scale, cudaStream_t stream) {
  // the opt-in to more than 48 KB of shared memory, once per kernel
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(mhsa_bf16_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bf16_smem<D>(1 + 2 * kRegTiles));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mhsa_bf16_stream_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bf16_smem<D>(5));
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap mq, mk, mv;
  int err;
  if ((err = head_map(&mq, q, str, batch, seq, heads, D)) ||
      (err = head_map(&mk, k, str, batch, seq, heads, D)) ||
      (err = head_map(&mv, v, str, batch, seq, heads, D)))
    return err;
  const int inner = str.head < str.token;
  const dim3 grid((seq + kQTile - 1) / kQTile, heads, batch);
  if (seq <= kRegKeys) {
    mhsa_bf16_kernel<D><<<grid, kWg, bf16_smem<D>(1 + 2 * kRegTiles), stream>>>(
        mq, mk, mv, o, str, inner, seq, scale);
  } else {
    mhsa_bf16_stream_kernel<D><<<grid, kWg, bf16_smem<D>(5), stream>>>(mq, mk, mv, o, str, inner,
                                                                       seq, scale);
  }
  return (int)cudaGetLastError();
}

int launch_mhsa(const bf16* q, const bf16* k, const bf16* v, bf16* o, HeadStrides str,
                int batch, int seq, int heads, int dim, float scale, cudaStream_t stream) {
  if (bad_shape(batch, seq, heads, dim)) return (int)cudaErrorInvalidValue;
  switch (dim) {
    case 16: return launch_mhsa_bf16<16>(q, k, v, o, str, batch, seq, heads, scale, stream);
    case 32: return launch_mhsa_bf16<32>(q, k, v, o, str, batch, seq, heads, scale, stream);
    case 64: return launch_mhsa_bf16<64>(q, k, v, o, str, batch, seq, heads, scale, stream);
    default: return launch_mhsa_bf16<128>(q, k, v, o, str, batch, seq, heads, scale, stream);
  }
}

HeadStrides packed_strides(int seq, int heads, int dim) {
  const long long c = (long long)heads * dim;
  return {seq * c, dim, c};
}

}  // namespace
