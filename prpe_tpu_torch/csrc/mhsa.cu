// Multi-head self-attention entry points over two layouts; the kernels are
// in mhsa_core.cuh.
//
// prpe_mhsa_packed_*: the packed (B, T, H*D) layout that the q/k/v
// projections write. Replaces prpe_tpu/ops/pallas/attention_kernel.py::
// _mhsa_kernel_packed (_pallas_forward(variant="packed")): head h of token t
// sits at offset t*C + h*D, so no transposes are needed on either side.
//
// prpe_mhsa_bhtd_*: the (B, H, T, D) layout. Replaces the three Pallas
// kernels that _pallas_forward launches on that layout: _mhsa_kernel_batched
// ("batched"), _mhsa_kernel ("unrolled") and _mhsa_kernel_bh ("bh"). They
// compute one function on one layout, with bit-identical outputs; their
// bodies differ only in how Mosaic schedules the heads of an image inside a
// TPU program (a batched dot_general, an unrolled loop, or a grid axis of
// one head per program). On the card one block per (query tile, head,
// image) already covers each of those schedules, so one kernel, given the
// (B, H, T, D) strides, serves all three.

#include "mhsa_core.cuh"

namespace {

HeadStrides bhtd_strides(int seq, int heads, int dim) {
  const long long plane = (long long)seq * dim;
  return {heads * plane, plane, dim};
}

}  // namespace

extern "C" int prpe_mhsa_packed_f32(const void* q, const void* k, const void* v, void* o,
                                    int batch, int seq, int heads, int dim, float scale,
                                    void* stream) {
  return launch_mhsa((const float*)q, (const float*)k, (const float*)v, (float*)o,
                     packed_strides(seq, heads, dim), batch, seq, heads, dim, scale,
                     (cudaStream_t)stream);
}

extern "C" int prpe_mhsa_packed_bf16(const void* q, const void* k, const void* v, void* o,
                                     int batch, int seq, int heads, int dim, float scale,
                                     void* stream) {
  return launch_mhsa((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                     packed_strides(seq, heads, dim), batch, seq, heads, dim, scale,
                     (cudaStream_t)stream);
}

extern "C" int prpe_mhsa_bhtd_f32(const void* q, const void* k, const void* v, void* o,
                                  int batch, int seq, int heads, int dim, float scale,
                                  void* stream) {
  return launch_mhsa((const float*)q, (const float*)k, (const float*)v, (float*)o,
                     bhtd_strides(seq, heads, dim), batch, seq, heads, dim, scale,
                     (cudaStream_t)stream);
}

extern "C" int prpe_mhsa_bhtd_bf16(const void* q, const void* k, const void* v, void* o,
                                   int batch, int seq, int heads, int dim, float scale,
                                   void* stream) {
  return launch_mhsa((const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
                     bhtd_strides(seq, heads, dim), batch, seq, heads, dim, scale,
                     (cudaStream_t)stream);
}
