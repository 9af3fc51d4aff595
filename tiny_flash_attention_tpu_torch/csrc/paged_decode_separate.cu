// One-token GQA decode attention over separate K and V page arrays, for
// Hopper (sm_90a).
//
// Replaces tiny_flash_attention_tpu/ops/paged.py::paged_decode_attention
// (_paged_decode_kernel): K and V pages (hkv, num_pages, ps, D) in q's dtype,
// or int8 payloads with f32 per-token scales (hkv, num_pages, ps, 1). The TPU
// kernel's double-buffered page DMAs and early stop are, on Hopper, the
// decode kernel of paged_decode.cuh (split-KV: blocks over page-aligned
// ranges of the table, each warp's chunks landing by bulk copies through a
// ring in shared memory, the walk ending at the length, the splits merged in
// order by the last to arrive) with the separate-array page layout; its
// design and bound are there. The attended length is clamped to the table
// width, and length 0 gives out 0 and the LSE sentinel, where the TPU
// kernel leaves the output unwritten in both cases.

#include "paged_decode.cuh"

namespace {

template <typename T, typename P, int D>
cudaError_t launch_separate(int group, const void* q, const void* k,
                            const void* v, const void* k_scales,
                            const void* v_scales, const void* lengths,
                            const void* page_indices, int pi_stride,
                            int pages_per_seq, int splits,
                            int pages_per_split, void* out, void* lse,
                            void* ws, void* arrivals, int batch, int hkv,
                            int qblocks, int num_pages, int page_size,
                            float scale_log2, cudaStream_t stream) {
  const SeparatePages<P, D> layout{
      static_cast<const P*>(k), static_cast<const P*>(v),
      static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), num_pages, page_size};
  return launch_group<T, P, D, false>(
      group, q, layout, lengths, page_indices, pi_stride, pages_per_seq,
      splits, pages_per_split, out, lse, ws, arrivals, batch, hkv, qblocks,
      0, scale_log2, stream);
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. dtype (of q and
// out): 0 bf16, 1 f32; quantized: 0 pages of q's dtype (the scale pointers
// are ignored), 1 int8 pages with f32 scales. head_dim: 64, 80, 96, 128
// or 256; hq = hkv * qblocks * group, group 1, 2, 4 or 8 (at most 4 at
// 256); page_size 16 or a multiple of 32. splits,
// pages_per_split, ws and arrivals as in tfa_paged_decode. The caller has
// checked shapes, contiguity and 16-byte alignment.
extern "C" int tfa_paged_decode_separate(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* lengths, const void* page_indices,
    int pi_stride, int pages_per_seq, int splits, int pages_per_split,
    void* out, void* lse, void* ws, void* arrivals, int batch, int hq,
    int hkv, int qblocks, int num_pages, int page_size, int head_dim,
    float scale_log2, int dtype, int quantized, void* stream) {
  if (batch <= 0 || hkv <= 0 || qblocks <= 0 || hq % (hkv * qblocks) != 0 ||
      page_size <= 0 || (page_size != 16 && page_size % 32) ||
      pages_per_seq <= 0 ||
      splits < 1 || pages_per_split < 1 ||
      (splits > 1 && (ws == nullptr || arrivals == nullptr)) ||
      (quantized && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int group = hq / (hkv * qblocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFA_DECODE_ARGS                                                   \
  group, q, k, v, k_scales, v_scales, lengths, page_indices, pi_stride,  \
      pages_per_seq, splits, pages_per_split, out, lse, ws, arrivals,     \
      batch, hkv, qblocks, num_pages, page_size, scale_log2, s
#define TFA_DECODE_DISPATCH(T, P)                                         \
  if (head_dim == 128)                                                    \
    return (int)launch_separate<T, P, 128>(TFA_DECODE_ARGS);              \
  if (head_dim == 256)                                                    \
    return (int)launch_separate<T, P, 256>(TFA_DECODE_ARGS);              \
  if (head_dim == 64) return (int)launch_separate<T, P, 64>(TFA_DECODE_ARGS); \
  if (head_dim == 96) return (int)launch_separate<T, P, 96>(TFA_DECODE_ARGS); \
  if (head_dim == 80) return (int)launch_separate<T, P, 80>(TFA_DECODE_ARGS); \
  return (int)cudaErrorInvalidValue
  if (dtype == 0 && !quantized) {
    TFA_DECODE_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  }
  if (dtype == 0 && quantized) {
    TFA_DECODE_DISPATCH(__nv_bfloat16, int8_t);
  }
  if (dtype == 1 && !quantized) {
    TFA_DECODE_DISPATCH(float, float);
  }
  if (dtype == 1 && quantized) {
    TFA_DECODE_DISPATCH(float, int8_t);
  }
#undef TFA_DECODE_DISPATCH
#undef TFA_DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}
