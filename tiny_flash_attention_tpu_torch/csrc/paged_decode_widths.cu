// One-token GQA decode attention over fused KV pages, for Hopper (sm_90a):
// bf16 q, over bf16 pages and over int8 pages, the run-time width instances
// (f32 q: paged_decode_widths_f32.cu; the compiled widths: paged_decode.cu;
// the sources build in parallel).
//
// Replaces tiny_flash_attention_tpu/ops/paged_fused.py::
// fused_paged_decode_attention (_fused_decode_kernel) at every head_dim up
// to 256 and page size that the compiled widths do not take (a head_dim
// other than 64, 80, 96, 128 and 256, or a page size other than 16 or a
// multiple of 32): instances of width 64, 128 and 256 that read rows of
// any d up to their width in place, each token's K and V rows copied by
// cp.async in the largest pieces that divide a row, zeros past d in shared
// memory, the int8 scale bytes read from the page; the sliding-window ring
// mode included. The kernel, its design and what bounds it are in
// paged_decode.cuh.

#include "paged_decode.cuh"

// tfa_paged_decode's contract (paged_decode.cu) at any head_dim in [1, 256]
// and any page_size >= 1 (int8 pages: page_size <= head_dim or a multiple
// of it, the scale rows of JAX's format).
extern "C" int tfa_paged_decode_widths(
    const void* q, const void* pages, const void* lengths,
    const void* page_indices, int pi_stride, int pages_per_seq, int splits,
    int pages_per_split, void* out, void* lse, void* ws, void* arrivals,
    int batch, int hq, int hkv, int qblocks, int num_pages, int page_size,
    int page_rows, int head_dim, int window, float scale_log2, int dtype,
    int quantized, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)fused_decode<__nv_bfloat16, true>(
      q, pages, lengths, page_indices, pi_stride, pages_per_seq, splits,
      pages_per_split, out, lse, ws, arrivals, batch, hq, hkv, qblocks,
      num_pages, page_size, page_rows, head_dim, window, scale_log2,
      quantized, static_cast<cudaStream_t>(stream));
}
