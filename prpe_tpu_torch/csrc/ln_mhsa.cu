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
//   1. LayerNorm, one warp per row with the row in registers, into plane 0;
//   2. a tiled GEMM for q|k|v (three weights in one launch) into planes
//      1..3, bias in the epilogue;
//   3. the attention kernel over the packed planes, into plane 0 (the
//      normalised rows are dead by then);
//   4. a tiled GEMM for the output projection with bias and residual.
// The TPU kernel groups 1, 2 or 4 images per program so that its in-kernel
// GEMMs have M = images * T rows; here every GEMM runs over all B*T rows at
// once, so that grouping has no counterpart. The weights keep the port's
// (out, in) layout, which is the K-major B operand both GEMMs read: no
// transposed copy. Stages 1 and 2/4 are also exported alone
// (prpe_layernorm_{f32,bf16}, prpe_linear_{f32,bf16}) so that each can be
// timed.
//
// What bounds it on the H100: 1.019 GFLOP per ViT-B image (four
// 192x768x768 GEMMs and the attention) against about 2.4 MB of bf16 bytes
// in and out per image (4.7 MB in fp32), about 430 (fp32: 215) FLOP per
// byte: above both ridges, so the bound is operations, nearly all of them in
// the GEMMs. The bf16 GEMM therefore runs on wgmma with its loads in flight
// behind the products; the fp32 GEMM on CUDA-core FFMA (fp32 stays fp32: no
// TF32, whose 10-bit mantissa the tensor cores would round the operands to),
// with register tiles large enough that the shared-memory pipe keeps pace
// with the FMAs (below). The LayerNorm moves bytes only: it reads x once.

#include <climits>

#include "mhsa_core.cuh"

namespace {

// ------------------------------------------------------------- LayerNorm
//
// One warp a row, the row in registers: lane l holds the row's 16-byte
// vectors l, l + 32, ..., l + 32 (NV - 1) (4 fp32 or 8 bf16 values each), so
// a warp's load is 512 contiguous bytes and x is read from memory once (at
// C = 768: 6 fp32 or 3 bf16 vectors a lane, 24 values). Vectors past the
// row's end are zeros and are neither counted nor stored. The statistics are
// layernorm_plain's, two passes over the registers: each lane sums its
// values in row order, a butterfly of xor shuffles adds the 32 partial sums
// (each step adds two equal pairs in either order, so every lane ends with
// the same bits), mu = sum / C; the same over (x - mu)^2 gives var, and
// inv = 1 / sqrt(var + eps). y = (x - mu) * inv * g + b in fp32, rounded to
// T; g and b are read as 16-byte vectors too. NV is the smallest
// instantiated count that holds the row (up to 16: C <= 2048 fp32, 4096
// bf16). At B = 32 the stage moves 37.7 MB in fp32 (18.9 MB in bf16):
// 0.01127 ms (0.00564) at 3.35 TB/s.

constexpr int kLnRows = kThreads / 32;  // rows per block, one warp each
constexpr int kLnMaxVecs = 16;          // 16-byte vectors a lane holds at most

// 16 bytes of T at p as floats, and back
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ b, T* __restrict__ y, int rows, int cols,
                 float eps) {
  constexpr int V = 16 / sizeof(T);
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const int nv = cols / V;
  const T* xr = x + (size_t)row * cols;
  float v[NV][V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {  // every load issued before any is used
    if (32 * j + lane < nv) {
      load_vec(xr + (32 * j + lane) * V, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[j][e] = 0.0f;
    }
  }
  float sum = 0.0f;  // zeros past the end add nothing
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) sum += v[j][e];
  const float mu = warp_sum(sum) / cols;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (32 * j + lane < nv) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[j][e] - mu;
        sq += d * d;
      }
    }
  }
  const float inv = 1.0f / sqrtf(warp_sum(sq) / cols + eps);
  T* yr = y + (size_t)row * cols;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c0 = (32 * j + lane) * V;
    if (c0 < cols) {
#pragma unroll
      for (int h = 0; h < V; h += 4) {
        const float4 gq = *reinterpret_cast<const float4*>(g + c0 + h);
        const float4 bq = *reinterpret_cast<const float4*>(b + c0 + h);
        float* o = v[j] + h;
        o[0] = (o[0] - mu) * inv * gq.x + bq.x;
        o[1] = (o[1] - mu) * inv * gq.y + bq.y;
        o[2] = (o[2] - mu) * inv * gq.z + bq.z;
        o[3] = (o[3] - mu) * inv * gq.w + bq.w;
      }
      store_vec(yr + c0, v[j]);
    }
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

// round(float(a) + float(b)) for eight bf16 pairs, as linear_plain adds the
// residual
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

// fp32 on CUDA-core FFMA. The limit is the shared-memory pipe: a 16-byte
// shared load holds it four cycles a warp (one per quarter warp), so a
// thread tile of a x b outputs, reading a + b float4s for 4ab FMAs, keeps
// pace with the FMA rate (four warp FFMAs a cycle an SM) only if
// ab / (a + b) >= 4. Each thread computes kTM x kTN = 6 x 16 outputs (ratio
// 4.4): rows ty + 16 i (i < 6), columns 4 tx + 32 jj + e (jj < 4, e < 4), so
// its stores are 16-byte vectors and a quarter warp (eight lanes of one ty,
// tx = 0..7) stores 128 contiguous bytes of a row. 128 threads in kRG = 16
// row groups by kCG = 8 column groups (ty = lane / 8 + 4 warp, tx = lane % 8)
// make a 96 x 128 block tile. ptxas uses 254 registers a thread (96
// accumulators, 24 operand registers), so two blocks run on an SM: 264
// slots on 132 SMs. Tiles and waves (tiles / 264):
//   B = 32  (M = 6144):  q|k|v 3 x 64 x 6 = 1152 tiles, 4.36 waves;
//                        proj 384 tiles, 1.45 waves;
//   B = 128 (M = 24576): q|k|v 4608 tiles, 17.45 waves; proj 1536, 5.82.
// The tile was chosen on the card (tools/variants.py, NVIDIA H100 80GB HBM3,
// 700 W): capped at 168 registers for three blocks an SM (396 slots, one
// wave for the B = 32 projection) ptxas spilled and the projection took
// 0.192 ms against 0.180; 96 x 192 tiles of 12 x 12 (2.91 and 0.97 waves)
// spilled at 255 registers (0.200 ms); 64 x 192 read 14 % more bytes from
// L2 per output (0.183 ms; B = 128 2 % slower); 128 x 96 tiles of 8 x 12 ran
// the B = 32 projection in 0.180 or 0.224 ms from one run of 25 launches to
// the next; a persistent grid that walks the tiles in launch order ran it in
// 0.228.
//
// Both operands are K-major as stored, so cp.async copies them unchanged:
// a k step is 16 deep, each row of a tile 64 bytes (four 16-byte chunks),
// two rows to a 128-byte bank line, in a ring of kFStages stages (a tile of
// a then one of w, 14 KB a stage). The inner loop reads, for each 4-deep
// chunk c, a float4 of each of its 6 rows of a and of its 16 rows of w
// (columns of the output), then does 6 x 16 x 4 FMAs in k order.
//  - a: row r, chunk c at float 16 r + 4 c, unswizzled. The eight lanes of a
//    quarter warp read one row (a broadcast), and a copy's eight lanes write
//    rows 2q, 2q + 1 whole: one bank line, conflict-free.
//  - w: row r, chunk c in bank line r / 2 at 16-byte slot
//    (4 (r & 1) + c) ^ ((r >> 2) & 7). A quarter warp reads rows
//    4 tx + 32 jj + e with tx = 0..7: slots (4 (e & 1) + c) ^ tx, eight
//    distinct slots, so no conflict (unswizzled, the eight rows, 4 apart,
//    would all fall on one bank group: an 8-way conflict). A copy's eight
//    lanes write rows 2q, 2q + 1, which share (r >> 2) & 7: slots 0..7
//    permuted, conflict-free.
// One barrier a k step: wait for this thread's copies of step kt, sync (the
// block's copies have landed and every thread is done with step kt - 1),
// refill step kt - 1's stage with step kt + kFStages - 1, multiply. The
// epilogue keeps linear_plain's numerics: the fp32 bias added to the fp32
// sum, then the residual, in 16-byte loads and stores. Blocks are ordered as
// the bf16 GEMM's: those that read one row block of a run together.
constexpr int kCG = 8, kRG = 128 / kCG;  // column and row groups of threads
constexpr int kTM = 6, kTN = 16;         // thread tile: rows kRG apart, columns in 4-groups
constexpr int kFThreads = 128, kFBlocks = 2, kFStages = 4;
constexpr int kFM = kRG * kTM, kFN = kCG * kTN, kFK = 16;
constexpr int kFC = kFK / 4;                               // 16-byte chunks a tile row
constexpr int kFPass = kFThreads / kFC;                    // tile rows one pass of copies fills
constexpr int kFStage = (kFM + kFN) * kFK;                 // floats of one stage
constexpr size_t kFSmem = (size_t)kFStages * kFStage * 4;  // 56 KB
static_assert(kCG % 8 == 0 && kTN % 4 == 0, "a quarter warp reads eight swizzle slots");
static_assert(kFC == 4 || kFC == 8, "a bank line holds two tile rows or one");
static_assert(kFM % kFPass == 0 && kFN % kFPass == 0, "copies split evenly over the threads");

// float offset of chunk c of row r in a stage's w tile: the chunk's
// unswizzled place q = kFC r + c, its slot in the 128-byte line xor'ed
// with (r >> 2) & 7
__device__ __forceinline__ int w_at(int r, int c) {
  const int q = kFC * r + c;
  return 4 * ((q & ~7) | ((q & 7) ^ ((r >> 2) & 7)));
}

__global__ void __launch_bounds__(kFThreads, kFBlocks) gemm_f32_kernel(Gemm<float> g) {
  extern __shared__ float4 fsm[];
  float* sm = reinterpret_cast<float*>(fsm);
  const int ntn = (g.n + kFN - 1) / kFN;
  const int z = blockIdx.x / ntn;
  const int m0 = blockIdx.y * kFM, n0 = (blockIdx.x - z * ntn) * kFN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (lane & 7) + 8 * (warp % (kCG / 8)), ty = (lane >> 3) + 4 * (warp / (kCG / 8));
  const int nk = (g.k + kFK - 1) / kFK;

  // copies: chunk cc of rows cr + kFPass p of each tile; a chunk outside its
  // matrix is zeros (read from a valid address with a source size of 0)
  const int cr = tid / kFC, cc = tid % kFC;
  const float* a_src = g.a + 4 * cc;
  const float* w_src = part(g.w, z) + 4 * cc;
  int a_row[kFM / kFPass], w_row[kFN / kFPass];  // element offsets of the rows
  unsigned a_in = 0, w_in = 0;  // bit p: row cr + kFPass p is in the matrix
#pragma unroll
  for (int p = 0; p < kFM / kFPass; ++p) {
    const int r = m0 + cr + kFPass * p;
    a_row[p] = min(r, g.m - 1) * g.k;
    a_in |= (unsigned)(r < g.m) << p;
  }
#pragma unroll
  for (int p = 0; p < kFN / kFPass; ++p) {
    const int r = n0 + cr + kFPass * p;
    w_row[p] = min(r, g.n - 1) * g.k;
    w_in |= (unsigned)(r < g.n) << p;
  }
  auto load = [&](int kt, int slot) {
    float* as = sm + slot * kFStage + kFK * cr + 4 * cc;
    float* ws = sm + slot * kFStage + kFM * kFK;
    const int k0 = kt * kFK;
    const bool kin = k0 + 4 * cc < g.k;
#pragma unroll
    for (int p = 0; p < kFM / kFPass; ++p) {
      const bool in = kin && (a_in >> p & 1);
      cp_async16(as + kFK * kFPass * p, in ? a_src + a_row[p] + k0 : g.a, in);
    }
#pragma unroll
    for (int p = 0; p < kFN / kFPass; ++p) {
      const bool in = kin && (w_in >> p & 1);
      cp_async16(ws + w_at(cr + kFPass * p, cc), in ? w_src + w_row[p] + k0 : g.a, in);
    }
  };
#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();
    if (kt + kFStages - 1 < nk) load(kt + kFStages - 1, (kt + kFStages - 1) % kFStages);
    cp_async_commit();  // an empty group at the tail keeps the count of groups in step
    const float* as = sm + (kt % kFStages) * kFStage + kFK * ty;
    // row 4 tx of the w tile starts a bank line; (r >> 2) & 7 is tx & 7 for
    // every row 4 tx + 4 kCG jj + e this thread reads
    const float* ws = sm + (kt % kFStages) * kFStage + kFM * kFK + 4 * kFK * tx;
    const int sw = tx & 7;
#pragma unroll
    for (int c = 0; c < kFC; ++c) {
      float4 a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + kFK * kRG * i + 4 * c);
#pragma unroll
      for (int jj = 0; jj < kTN / 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = kFC * e + c;  // w_at of row 4 tx + 4 kCG jj + e, chunk c
          const float4 b = *reinterpret_cast<const float4*>(
              ws + 4 * kFK * kCG * jj + 4 * ((q & ~7) | ((q & 7) ^ sw)));
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            float& s = acc[i][4 * jj + e];
            s = fmaf(a[i].x, b.x, s);
            s = fmaf(a[i].y, b.y, s);
            s = fmaf(a[i].z, b.z, s);
            s = fmaf(a[i].w, b.w, s);
          }
        }
      }
    }
  }

  // epilogue, a column group at a time: the residual's loads all issued
  // before any store (a store may alias a later load as far as the compiler
  // knows, which would serialise them)
  const float* bias = part(g.bias, z);
  float* out = part(g.out, z);
#pragma unroll
  for (int jj = 0; jj < kTN / 4; ++jj) {
    const int col = n0 + 4 * tx + 4 * kCG * jj;  // n % 8 == 0: a 4-group is wholly in or out
    if (col >= g.n) continue;
    const float4 bv = *reinterpret_cast<const float4*>(bias + col);
    float4 res[kTM];
    if (g.residual) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int row = m0 + ty + kRG * i;
        if (row < g.m)
          res[i] = *reinterpret_cast<const float4*>(g.residual + (size_t)row * g.n + col);
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = m0 + ty + kRG * i;
      if (row >= g.m) continue;
      const int j = 4 * jj;
      float4 y = make_float4(acc[i][j] + bv.x, acc[i][j + 1] + bv.y, acc[i][j + 2] + bv.z,
                             acc[i][j + 3] + bv.w);
      if (g.residual)
        y = make_float4(res[i].x + y.x, res[i].y + y.y, res[i].z + y.z, res[i].w + y.w);
      *reinterpret_cast<float4*>(out + (size_t)row * g.n + col) = y;
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
  if (g.m <= 0 || g.n <= 0 || g.k <= 0 || g.n % 8 || g.k % 8) return (int)cudaErrorInvalidValue;
  if ((long long)g.m * g.k > INT_MAX || (long long)g.n * g.k > INT_MAX ||  // int row offsets
      (g.m + kFM - 1) / kFM > 65535)                                        // grid.y
    return (int)cudaErrorInvalidValue;
  // 56 KB a block, two blocks an SM: the largest shared-memory carveout
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFSmem);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(gemm_f32_kernel,
                                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                                   (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(parts * ((g.n + kFN - 1) / kFN), (g.m + kFM - 1) / kFM);
  gemm_f32_kernel<<<grid, kFThreads, kFSmem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
void layernorm_launch(const T* x, const float* w, const float* b, T* y, int rows, int cols,
                      float eps, cudaStream_t stream) {
  layernorm_kernel<T, NV><<<(rows + kLnRows - 1) / kLnRows, kThreads, 0, stream>>>(
      x, w, b, y, rows, cols, eps);
}

// cols a multiple of the 16-byte vector (4 fp32, 8 bf16), at most
// 32 * kLnMaxVecs vectors
template <typename T>
int launch_layernorm(const T* x, const float* w, const float* b, T* y, int rows, int cols,
                     float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int per_lane = (cols / V + 31) / 32;
  if (rows <= 0 || cols <= 0 || cols % V || per_lane > kLnMaxVecs)
    return (int)cudaErrorInvalidValue;
  if (per_lane <= 1) layernorm_launch<T, 1>(x, w, b, y, rows, cols, eps, stream);
  else if (per_lane <= 2) layernorm_launch<T, 2>(x, w, b, y, rows, cols, eps, stream);
  else if (per_lane <= 3) layernorm_launch<T, 3>(x, w, b, y, rows, cols, eps, stream);
  else if (per_lane <= 4) layernorm_launch<T, 4>(x, w, b, y, rows, cols, eps, stream);
  else if (per_lane <= 6) layernorm_launch<T, 6>(x, w, b, y, rows, cols, eps, stream);
  else if (per_lane <= 8) layernorm_launch<T, 8>(x, w, b, y, rows, cols, eps, stream);
  else if (per_lane <= 12) layernorm_launch<T, 12>(x, w, b, y, rows, cols, eps, stream);
  else layernorm_launch<T, kLnMaxVecs>(x, w, b, y, rows, cols, eps, stream);
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

// Stage 1 alone: y = LayerNorm(x) over rows of ``cols``, fp32 scale and
// shift; cols a multiple of 16 bytes of the dtype, at most 2048 fp32 or
// 4096 bf16 values.
template <typename T>
int layernorm(const void* x, const void* w, const void* b, void* y, int rows, int cols, float eps,
              void* stream) {
  return launch_layernorm((const T*)x, (const float*)w, (const float*)b, (T*)y, rows, cols, eps,
                          (cudaStream_t)stream);
}

// Stages 2 and 4 alone: out = round(a @ w^T + bias) (+ residual when not
// null), a (m, k), w (n, k), out and residual (m, n); k and n multiples of 8.
template <typename T>
int linear(const void* a, const void* w, const void* bias, const void* residual, void* out, int m,
           int n, int k, void* stream) {
  const T* wt = (const T*)w;
  const float* bt = (const float*)bias;
  T* ot = (T*)out;
  const Gemm<T> g{(const T*)a, {wt, wt, wt}, {bt, bt, bt}, {ot, ot, ot}, (const T*)residual,
                  m, n, k};
  return launch_gemm(g, 1, (cudaStream_t)stream);
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

extern "C" int prpe_layernorm_f32(const void* x, const void* w, const void* b, void* y, int rows,
                                  int cols, float eps, void* stream) {
  return layernorm<float>(x, w, b, y, rows, cols, eps, stream);
}

extern "C" int prpe_layernorm_bf16(const void* x, const void* w, const void* b, void* y,
                                   int rows, int cols, float eps, void* stream) {
  return layernorm<bf16>(x, w, b, y, rows, cols, eps, stream);
}

extern "C" int prpe_linear_f32(const void* a, const void* w, const void* bias,
                               const void* residual, void* out, int m, int n, int k,
                               void* stream) {
  return linear<float>(a, w, bias, residual, out, m, n, k, stream);
}

extern "C" int prpe_linear_bf16(const void* a, const void* w, const void* bias,
                                const void* residual, void* out, int m, int n, int k,
                                void* stream) {
  return linear<bf16>(a, w, bias, residual, out, m, n, k, stream);
}
