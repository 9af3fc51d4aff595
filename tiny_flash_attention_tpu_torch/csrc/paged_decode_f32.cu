// One-token GQA decode attention over fused KV pages, for Hopper (sm_90a):
// f32 q, over f32 pages and over int8 pages (bf16 q: paged_decode.cu; the
// two sources build in parallel).
//
// Replaces tiny_flash_attention_tpu/ops/paged_fused.py::
// fused_paged_decode_attention (_fused_decode_kernel) for f32 models, with
// and without its sliding-window ring mode. The kernel, its design and what
// bounds it are in paged_decode.cuh (f32 pages at head_dim 256 on blocks of
// TFA_DECODE_F32_WIDE_WARPS warps, `decode_warps`); this source
// instantiates it over fused pages.

#include "paged_decode.cuh"

// tfa_paged_decode's contract (paged_decode.cu) for dtype 1: f32 q and out,
// over f32 pages (quantized 0) or int8 pages (quantized 1), head_dim 64,
// 80, 96, 128 or 256 (above 256: paged_decode_f32_wide.cu).
extern "C" int tfa_paged_decode_f32(const void* q, const void* pages,
                                    const void* lengths,
                                    const void* page_indices, int pi_stride,
                                    int pages_per_seq, int splits,
                                    int pages_per_split, void* out,
                                    void* lse, void* ws, void* arrivals,
                                    int batch, int hq, int hkv, int qblocks,
                                    int num_pages, int page_size,
                                    int page_rows, int head_dim, int window,
                                    float scale_log2, int dtype,
                                    int quantized, void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)fused_decode<float, false>(
      q, pages, lengths, page_indices, pi_stride, pages_per_seq, splits,
      pages_per_split, out, lse, ws, arrivals, batch, hq, hkv, qblocks,
      num_pages, page_size, page_rows, head_dim, window, scale_log2,
      quantized, static_cast<cudaStream_t>(stream));
}
