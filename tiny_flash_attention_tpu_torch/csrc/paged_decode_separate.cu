// One-token GQA decode attention over separate K and V page arrays, for
// Hopper (sm_90a): the compiled widths (head_dim 64, 80, 96, 128, 256; the
// run-time widths are paged_decode_separate_widths.cu, built in parallel).
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
  return (int)separate_decode<false>(
      q, k, v, k_scales, v_scales, lengths, page_indices, pi_stride,
      pages_per_seq, splits, pages_per_split, out, lse, ws, arrivals, batch,
      hq, hkv, qblocks, num_pages, page_size, head_dim, scale_log2, dtype,
      quantized, static_cast<cudaStream_t>(stream));
}
