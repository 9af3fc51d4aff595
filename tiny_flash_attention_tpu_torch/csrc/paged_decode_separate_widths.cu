// One-token GQA decode attention over separate K and V page arrays, for
// Hopper (sm_90a): the run-time width instances (the compiled widths are
// paged_decode_separate.cu, built in parallel).
//
// Replaces tiny_flash_attention_tpu/ops/paged.py::paged_decode_attention
// (_paged_decode_kernel) at every head_dim up to 256 and page size the
// compiled widths do not take: instances of width 64, 128 and 256 that read
// rows of any d up to their width in place, each token's K and V rows
// copied by cp.async in the largest pieces that divide a row (or loaded,
// for rows of an odd number of bytes' halves), zeros past d in shared
// memory. The kernel, its design and what bounds it are in
// paged_decode.cuh.

#include "paged_decode.cuh"

// tfa_paged_decode_separate's contract (paged_decode_separate.cu) at any
// head_dim in [1, 256] and any page_size >= 1.
extern "C" int tfa_paged_decode_separate_widths(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* lengths, const void* page_indices,
    int pi_stride, int pages_per_seq, int splits, int pages_per_split,
    void* out, void* lse, void* ws, void* arrivals, int batch, int hq,
    int hkv, int qblocks, int num_pages, int page_size, int head_dim,
    float scale_log2, int dtype, int quantized, void* stream) {
  return (int)separate_decode<true>(
      q, k, v, k_scales, v_scales, lengths, page_indices, pi_stride,
      pages_per_seq, splits, pages_per_split, out, lse, ws, arrivals, batch,
      hq, hkv, qblocks, num_pages, page_size, head_dim, scale_log2, dtype,
      quantized, static_cast<cudaStream_t>(stream));
}
