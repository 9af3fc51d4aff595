// One-token GQA decode attention over separate K and V page arrays, for
// Hopper (sm_90a), at head dims in (256, 512]: bf16 q over bf16 pages and
// over int8 pages with f32 scales, on instances of width 512 (head_dim 512
// at page size 16 or a multiple of 32 compiled, every other head_dim and
// page size at run time); a source of its own, built beside the others.
//
// Replaces tiny_flash_attention_tpu/ops/paged.py::paged_decode_attention
// (_paged_decode_kernel) above head_dim 256, on B4's template
// (paged_decode.cuh, whose notes on design and bound hold here).

#include "paged_decode.cuh"

// tfa_paged_decode_separate's contract (paged_decode_separate.cu) for bf16
// q (dtype 0) at any head_dim in (256, 512] and any page_size >= 1; group
// 1 or 2.
extern "C" int tfa_paged_decode_separate_wide(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* lengths, const void* page_indices,
    int pi_stride, int pages_per_seq, int splits, int pages_per_split,
    void* out, void* lse, void* ws, void* arrivals, int batch, int hq,
    int hkv, int qblocks, int num_pages, int page_size, int head_dim,
    float scale_log2, int dtype, int quantized, void* stream) {
  const auto launch = [&](auto widths) {
    return (int)separate_decode<decltype(widths)::value, true>(
        q, k, v, k_scales, v_scales, lengths, page_indices, pi_stride,
        pages_per_seq, splits, pages_per_split, out, lse, ws, arrivals,
        batch, hq, hkv, qblocks, num_pages, page_size, head_dim, scale_log2,
        dtype, quantized, static_cast<cudaStream_t>(stream));
  };
  if (head_dim == 512 && (page_size == 16 || page_size % 32 == 0))
    return launch(std::false_type());
  return launch(std::true_type());
}
