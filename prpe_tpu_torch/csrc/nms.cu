// Greedy NMS keep mask for a batch of score-sorted candidate lists.
//
// Replaces prpe_tpu/ops/pallas/nms_kernel.py::_nms_kernel (launched by
// pallas_greedy_nms). Per image: the thresholded suppression matrix
// IoU(i, j) > thr over fp32 xyxy boxes that already carry the class offset,
// then the exact greedy scan over the candidates in index order, bounded at
// the last valid index + 1.
//
// What bounds it on the H100: neither bytes (B*K*18 bytes in and out) nor
// operations (at most K^2/2 IoUs of ~14 fp32 operations per image) but the
// serial scan, one dependent step per candidate. The design keeps the whole
// scan on chip: one block per image builds the suppression matrix as a bit
// matrix in shared memory (K x ceil(K/32) words, rows padded to an odd
// count: 9 KB at K = 256, 132 KB at K = 1024), then one warp walks it,
// each lane holding one 32-bit word of the `suppressed` mask in a register,
// so a step is two shuffles and one shared-memory load. Only rows and columns below the last valid index, and
// only words right of the diagonal, are computed.
//
// Exactness: the IoU expression and its evaluation order are those of the
// plain version (prpe_tpu_torch/ops/boxes.py::iou). The file is compiled with
// -fmad=false and IEEE division, so every keep bit equals the plain one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // phase 1 is the parallel part: one block per image
constexpr int kMaxK = 1024;
constexpr int kMaxWords = kMaxK / 32;

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int k, float thr) {
  extern __shared__ float smem[];
  const int words = (k + 31) / 32;
  float* x1 = smem;
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  // k rows of `stride` words; an odd stride keeps column stores conflict-free
  const int stride = words | 1;
  uint32_t* mask = reinterpret_cast<uint32_t*>(area + k);
  __shared__ uint32_t vmask[kMaxWords];
  __shared__ uint32_t keepw[kMaxWords];
  __shared__ int n_iter_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* bx = boxes + (size_t)b * k * 4;
  const uint8_t* va = valid + (size_t)b * k;

  for (int j = tid; j < k; j += kThreads) {
    const float a = bx[j * 4 + 0], c = bx[j * 4 + 1];
    const float e = bx[j * 4 + 2], d = bx[j * 4 + 3];
    x1[j] = a; y1[j] = c; x2[j] = e; y2[j] = d;
    area[j] = fmaxf(e - a, 0.0f) * fmaxf(d - c, 0.0f);
  }
  // validity as a bit mask: warp w covers candidates [32w, 32w + 32)
  for (int w = warp; w < words; w += kThreads / 32) {
    const int j = w * 32 + lane;
    const unsigned bit = __ballot_sync(0xffffffffu, j < k && va[j] != 0);
    if (lane == 0) vmask[w] = bit;
  }
  __syncthreads();
  if (warp == 0) {
    // n_iter = last valid index + 1
    const uint32_t v = lane < words ? vmask[lane] : 0u;
    int n = v ? lane * 32 + (32 - __clz(v)) : 0;
    for (int off = 16; off > 0; off >>= 1) n = max(n, __shfl_xor_sync(0xffffffffu, n, off));
    if (lane == 0) n_iter_s = n;
  }
  __syncthreads();
  const int n_iter = n_iter_s;
  const int wlim = (n_iter + 31) / 32;

  // phase 1: bit matrix rows i < n_iter, words from i's own word to wlim.
  // Neighbouring threads take neighbouring rows of one word, so the column
  // boxes x1[j].. are broadcast reads, free of bank conflicts.
  for (int t = tid; t < n_iter * wlim; t += kThreads) {
    const int w = t / n_iter;
    const int i = t - w * n_iter;
    if (w < (i >> 5)) continue;
    const float ax1 = x1[i], ay1 = y1[i], ax2 = x2[i], ay2 = y2[i], aa = area[i];
    uint32_t bits = 0u;
    const int j0 = w * 32;
    const int j1 = min(j0 + 32, n_iter);
    for (int j = j0; j < j1; ++j) {
      const float iw = fmaxf(fminf(ax2, x2[j]) - fmaxf(ax1, x1[j]), 0.0f);
      const float ih = fmaxf(fminf(ay2, y2[j]) - fmaxf(ay1, y1[j]), 0.0f);
      const float inter = iw * ih;
      const float iou = inter / (aa + area[j] - inter + 1e-7f);
      if (iou > thr) bits |= 1u << (j - j0);
    }
    mask[i * stride + w] = bits;
  }
  __syncthreads();

  // phase 2: the serial greedy scan, one warp; lane w owns word w
  if (warp == 0) {
    uint32_t sup = 0u, kept = 0u;
    const uint32_t vw = lane < words ? vmask[lane] : 0u;
    for (int i = 0; i < n_iter; ++i) {
      const int w = i >> 5;
      const uint32_t bit = 1u << (i & 31);
      const uint32_t sup_w = __shfl_sync(0xffffffffu, sup, w);
      const uint32_t val_w = __shfl_sync(0xffffffffu, vw, w);
      if ((val_w & bit) && !(sup_w & bit)) {  // warp-uniform branch
        if (lane >= w && lane < wlim) sup |= mask[i * stride + lane];
        if (lane == w) kept |= bit;
      }
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
  if (k <= 0 || k > kMaxK || batch <= 0) return (int)cudaErrorInvalidValue;
  const int words = (k + 31) / 32;
  const size_t smem = (size_t)5 * k * sizeof(float) + (size_t)k * (words | 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_keep_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const uint8_t*)valid, (uint8_t*)keep, k, thr);
  return (int)cudaGetLastError();
}
