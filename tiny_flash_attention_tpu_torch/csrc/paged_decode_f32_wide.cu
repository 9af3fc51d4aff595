// One-token GQA decode attention over fused KV pages, for Hopper (sm_90a),
// at head dims in (256, 512]: f32 q over f32 pages and over int8 pages, on
// instances of width 512 (head_dim 512 at page size 16 or a multiple of 32
// compiled, every other head_dim and page size at run time); a source of
// its own, so that nvcc builds it beside the others (bf16 q:
// paged_decode_wide.cu).
//
// Replaces tiny_flash_attention_tpu/ops/paged_fused.py::
// fused_paged_decode_attention (_fused_decode_kernel) above head_dim 256
// for f32 models, its sliding-window ring mode included. The kernel, its
// design at width 512 (TFA_DECODE_512_WARPS warps a block; f32 pages in
// 16-token chunks, `decode_chunk`) and what bounds it are in
// paged_decode.cuh.

#include "paged_decode.cuh"

// tfa_paged_decode's contract (paged_decode.cu) for f32 q (dtype 1) at any
// head_dim in (256, 512] and any page_size >= 1 (int8 pages: page_size <=
// head_dim or a multiple of it); group 1 or 2 (ops/dims.py::decode_group
// covers larger groups by row blocks of 2).
extern "C" int tfa_paged_decode_f32_wide(
    const void* q, const void* pages, const void* lengths,
    const void* page_indices, int pi_stride, int pages_per_seq, int splits,
    int pages_per_split, void* out, void* lse, void* ws, void* arrivals,
    int batch, int hq, int hkv, int qblocks, int num_pages, int page_size,
    int page_rows, int head_dim, int window, float scale_log2, int dtype,
    int quantized, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const auto launch = [&](auto widths) {
    return (int)fused_decode<float, decltype(widths)::value, true>(
        q, pages, lengths, page_indices, pi_stride, pages_per_seq, splits,
        pages_per_split, out, lse, ws, arrivals, batch, hq, hkv, qblocks,
        num_pages, page_size, page_rows, head_dim, window, scale_log2,
        quantized, static_cast<cudaStream_t>(stream));
  };
  if (head_dim == 512 && (page_size == 16 || page_size % 32 == 0))
    return launch(std::false_type());
  return launch(std::true_type());
}
