// Greedy NMS keep mask for a batch of score-sorted candidate lists.
//
// Replaces prpe_tpu/ops/pallas/nms_kernel.py::_nms_kernel (launched by
// pallas_greedy_nms). Per image: the thresholded suppression matrix
// IoU(i, j) > thr over fp32 xyxy boxes that already carry the class offset,
// then the exact greedy scan over the candidates in index order, bounded at
// the last valid index + 1.
//
// What bounds it on the H100: neither bytes (B*K*18 bytes in and out) nor
// operations (at most K^2/2 IoUs of ~14 fp32 operations per image) but
// latency. At B = 32, K = 256 an empty kernel of the same launch shape takes
// 5.1 us between CUDA events; clock64() probes (tools/nms_phases.py) put the
// rest in the matrix build and the scan. The one-block-per-image design
// spent about 18 us on each: one SM per image (32 of 132 SMs at B = 32), and
// a scan of one dependent shuffle-and-load round trip per candidate. The
// design:
//   - A cluster of kCtas = 3 blocks per image (one launch, B * kCtas blocks)
//     builds the matrix as bits: rows i < n_iter, words from i's own word up
//     to n_iter, one 32 x 32 block a warp, one row a lane. Each word goes
//     into the shared memory of the cluster's first block (distributed
//     shared memory). Three blocks, not four: 128 four-block clusters do not
//     fit on the card one block an SM, and the SMs that took two blocks held
//     every image back.
//   - The IoU test avoids the division: inter >= hi * union proves IoU > thr
//     and inter <= lo * union proves IoU <= thr, with hi and lo a hair above
//     and below thr (see prpe_nms_keep for why either test is exact). Only
//     pairs whose IoU is within about 2^-20 of thr (relative) divide.
//   - The first block's warp 0 then scans by 32-candidate words. In round w
//     the suppressed bits of word w are final; the warp finds the word's
//     kept set as the fixed point of K = cand & ~OR{diagonal row r : r in K}
//     with one warp-wide OR reduction a step (two steps on clustered boxes,
//     at most 33), then every later lane ORs the kept rows' words at its
//     column into its own word. K = 256 takes 8 rounds where a step per
//     candidate took 256 round trips.
//   - Every global load of the set-up is issued before any is used; the
//     shared-memory limit is raised once, at the first launch.
//
// Exactness: the IoU expression and its evaluation order are those of the
// plain version (prpe_tpu_torch/ops/boxes.py::iou). The file is compiled with
// -fmad=false and IEEE division, so every keep bit equals the plain one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCtas = 3;  // blocks of one image's cluster
constexpr int kMaxK = 1024;
constexpr int kMaxWords = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory: boxes as float4 (x1, y1, x2, y2) and their areas, both
// padded with empty boxes to whole words, then the bit matrix column-major:
// word w of row i at col_stride * w + i. 32 lanes on 32 rows of one column
// read or write one wavefront, and a stride of 4 mod 32 words lets eight
// lanes read eight columns as 16-byte vectors in one wavefront too.
__host__ __device__ inline int n_words(int k) { return (k + 31) / 32; }
__host__ __device__ inline int col_stride(int k) { return 32 * n_words(k) + 4; }
size_t smem_bytes(int k) {
  return (size_t)(16 + 4) * 32 * n_words(k) + (size_t)4 * n_words(k) * col_stride(k);
}

// the plain version's intersection and union (ops/boxes.py::iou), in its order
__device__ __forceinline__ void inter_union(float4 r, float ra, float4 o, float ao, float& inter,
                                            float& uni) {
  const float iw = fmaxf(fminf(r.z, o.z) - fmaxf(r.x, o.x), 0.0f);
  const float ih = fmaxf(fminf(r.w, o.w) - fmaxf(r.y, o.y), 0.0f);
  inter = iw * ih;
  uni = ra + ao - inter + 1e-7f;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// thr_hi / thr_lo bracket thr (see prpe_nms_keep): inter >= thr_hi * union
// proves IoU > thr and inter <= thr_lo * union proves IoU <= thr, each
// without the division; only pairs in the thin band between divide. An
// image with an area of 1e37 or more (or not a number) divides every pair.
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int k, float thr, float thr_hi, float thr_lo) {
  extern __shared__ float4 smem[];
  // every block of the cluster has started once the first wait returns
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int words = n_words(k);
  const int stride = col_stride(k);
  float4* box = smem;
  float* area = reinterpret_cast<float*>(box + 32 * words);
  uint32_t* mask = reinterpret_cast<uint32_t*>(area + 32 * words);
  __shared__ uint32_t vmask[kMaxWords];
  __shared__ uint32_t keepw[kMaxWords];

  const int b = blockIdx.x / kCtas;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* bx = boxes + (size_t)b * k * 4;
  const uint8_t* va = valid + (size_t)b * k;

  // candidates tid and tid + kThreads, every load issued before any is used
  // (boxes 16-byte aligned: the wrapper sees to it); past K an empty box,
  // whose bits are masked
  static_assert(kMaxK <= 2 * kThreads, "two candidates a thread");
  bool huge = false, valid_j[2];
  float4 o[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = tid + h * kThreads;
    valid_j[h] = j < k && va[j] != 0;
    o[h] = j < k ? reinterpret_cast<const float4*>(bx)[j] : make_float4(0, 0, 0, 0);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = tid + h * kThreads;
    if (j < 32 * words) {
      box[j] = o[h];
      area[j] = fmaxf(o[h].z - o[h].x, 0.0f) * fmaxf(o[h].w - o[h].y, 0.0f);
      huge |= !(area[j] < 1e37f);
    }
    // validity as a bit mask: warp w covers candidates [32w, 32w + 32)
    const unsigned bits = __ballot_sync(kFull, valid_j[h]);
    if (lane == 0 && j < 32 * words) vmask[j >> 5] = bits;
  }
  if (__syncthreads_or(huge)) {
    thr_hi = INFINITY;
    thr_lo = -INFINITY;
  }
  // n_iter = last valid index + 1, in every warp
  const uint32_t vl = lane < words ? vmask[lane] : 0u;
  const int n_iter = (int)__reduce_max_sync(kFull, vl ? lane * 32 + (32 - __clz(vl)) : 0u);
  const int wlim = (n_iter + 31) / 32;
  cluster_wait();  // before any store into the first block
  uint32_t* mask0 = cluster.map_shared_rank(mask, 0);

  // phase 1: bit matrix rows i < n_iter, words from i's own word to wlim:
  // the 32 x 32 blocks (a, w), a <= w < wlim, numbered w-major, go to the
  // cluster's blocks in turn, one warp each. Lane r computes row 32 a + r
  // against the 32 columns of word w (each column box a broadcast load) and
  // stores the word into the first block's shared memory. The bracket tests
  // of a lane are straight-line code; the exact division runs after them,
  // for the pairs in the band only.
  const int n_blocks = wlim * (wlim + 1) / 2;
  for (int t = warp * kCtas + rank; t < n_blocks; t += kCtas * (kThreads / 32)) {
    int w = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
    if ((w + 1) * (w + 2) / 2 <= t) ++w;
    if (w * (w + 1) / 2 > t) --w;
    const int i = 32 * (t - w * (w + 1) / 2) + lane;
    if (i < n_iter) {
      const float4 r = box[i];
      const float ra = area[i];
      uint32_t bits = 0u, not_below = 0u;
#pragma unroll
      for (int jj = 0; jj < 32; ++jj) {
        float inter, uni;
        inter_union(r, ra, box[32 * w + jj], area[32 * w + jj], inter, uni);
        bits |= inter >= thr_hi * uni ? 1u << jj : 0u;
        not_below |= inter <= thr_lo * uni ? 0u : 1u << jj;
      }
      // columns past n_iter stay 0
      const int left = n_iter - 32 * w;
      const uint32_t in = left >= 32 ? kFull : (1u << left) - 1u;
      bits &= in;
      uint32_t band = not_below & ~bits & in;
      while (band) {
        const int bit = __ffs(band) - 1;
        band &= band - 1;
        float inter, uni;
        inter_union(r, ra, box[32 * w + bit], area[32 * w + bit], inter, uni);
        if (inter / uni > thr) bits |= 1u << bit;
      }
      mask0[w * stride + i] = bits;
    }
  }
  // only the first block's shared memory is read from here on: the others
  // signal that their stores are done and leave
  cluster_arrive_release();
  if (rank != 0) return;
  cluster_wait();  // the matrix is whole in the first block

  // phase 2: the scan by words, warp 0. Lane l holds word l of the
  // `suppressed` mask; in round w the bits of word w are final, and lane r
  // stands for row 32 w + r. The warp resolves word w's candidates
  // together: lane r holds row r of the diagonal block (bits after r only),
  // and the kept set K is the fixed point of K = cand & ~OR{row r : r in K},
  // reached by iterating from K = cand with one warp-wide OR reduction a
  // step. The fixed point is unique and is the greedy result; after n steps
  // the first n candidates are final, so at most 33 steps are taken (two or
  // three on clustered boxes). Then each later lane ORs the kept rows' words
  // at its column into its own word.
  if (warp == 0) {
    const uint32_t vw = lane < words ? vmask[lane] : 0u;
    uint32_t sup = 0u, kept = 0u;
    for (int w = 0; w < wlim; ++w) {
      const int row = 32 * w + lane;
      const uint32_t dg = row < n_iter ? mask[w * stride + row] & (0xfffffffeu << lane) : 0u;
      // word w's rows at this lane's column, for a later lane: vector loads
      // issued before the resolve, so their latency hides behind it. Rows
      // past n_iter hold stale words, but they are never kept.
      const bool later = lane > w && lane < wlim;
      uint32_t col[32];
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const uint4 d = later
            ? *reinterpret_cast<const uint4*>(mask + lane * stride + 32 * w + 4 * v)
            : make_uint4(0u, 0u, 0u, 0u);
        col[4 * v + 0] = d.x;
        col[4 * v + 1] = d.y;
        col[4 * v + 2] = d.z;
        col[4 * v + 3] = d.w;
      }
      const uint32_t cand = __shfl_sync(kFull, vw & ~sup, w);
      // the first two steps unconditionally (most words settle by then)
      const auto step = [&](uint32_t x) {
        return cand & ~__reduce_or_sync(kFull, (x >> lane) & 1u ? dg : 0u);
      };
      uint32_t prev = step(cand), kw = step(prev);
      while (kw != prev) {
        prev = kw;
        kw = step(kw);
      }
      if (lane == w) kept = kw;
      // the rows of the kept candidates, ORed in four independent chains
      uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i & 3] |= col[i] & (0u - ((kw >> i) & 1u));
      sup |= (acc[0] | acc[1]) | (acc[2] | acc[3]);
    }
    if (lane < words) keepw[lane] = kept;
  }
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    keep[(size_t)b * k + j] = (keepw[j >> 5] >> (j & 31)) & 1u;
  }
}

}  // namespace

extern "C" int prpe_nms_keep(const void* boxes, const void* valid, void* keep,
                             int batch, int k, float thr, void* stream) {
  if (k <= 0 || k > kMaxK || batch <= 0 || batch > (1 << 29)) return (int)cudaErrorInvalidValue;
  // the opt-in to more than 48 KB of shared memory, once, for the largest K
  static const cudaError_t attr = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(kMaxK));
  if (attr != cudaSuccess) return (int)attr;
  // The bracket: with hi >= thr (1 + 2^-21) and lo <= thr (1 - 2^-21), a
  // product p = RN(hi * union) >= hi * union (1 - 2^-24), so inter >= p gives
  // inter / union > thr (1 + 2^-22), above the midpoint between thr and the
  // next float: the rounded IoU exceeds thr. Likewise inter <= RN(lo * union)
  // gives inter / union < thr, so the rounded IoU is at most thr. This holds
  // while the products stay normal: thr in [2^-60, 1] and every area below
  // 1e37 (so 1e-7 <= union < 3e37); otherwise every pair divides.
  float hi = INFINITY, lo = -INFINITY;
  if (thr >= 0x1p-60f && thr <= 1.0f) {
    hi = (float)((double)thr * (1.0 + 0x1p-20));
    lo = (float)((double)thr * (1.0 - 0x1p-20));
  }
  nms_keep_kernel<<<batch * kCtas, kThreads, smem_bytes(k), (cudaStream_t)stream>>>(
      (const float*)boxes, (const uint8_t*)valid, (uint8_t*)keep, k, thr, hi, lo);
  return (int)cudaGetLastError();
}
