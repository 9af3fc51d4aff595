// One-token GQA decode attention over fused KV pages, for Hopper (sm_90a):
// bf16 q, over bf16 pages and over int8 pages, the compiled widths (f32 q:
// paged_decode_f32.cu; every other head_dim and page size:
// paged_decode_widths.cu; the sources build in parallel).
//
// Replaces tiny_flash_attention_tpu/ops/paged_fused.py::
// fused_paged_decode_attention (_fused_decode_kernel) for pages of q's
// dtype and for int8 pages with bit-packed f32 scale rows, with and without
// its sliding-window ring mode. The kernel, its design and what bounds it
// are in paged_decode.cuh; this source instantiates it over fused pages.

#include "paged_decode.cuh"

// Returns a cudaError_t: 0 when the kernel was launched. dtype (of q and
// out): 0 bf16 (paged_decode_f32.cu's tfa_paged_decode_f32 takes 1, f32);
// quantized: 0 pages of q's dtype with page_rows = 2 * page_size, 1 int8
// pages with page_rows = 2 * page_size + 2 * sr. head_dim: 64, 80, 96, 128
// or 256; hq = hkv * qblocks * group, group 1, 2, 4 or 8 q rows a block
// (at most 4 at 256), qblocks blocks of them a kv head (the caller pads the
// q heads); page_size 16 or a multiple of 32. window: 0 for none, else the
// ring mode over [length - window, length), window <= P * ps. splits
// blocks per (sequence, q row block) of pages_per_split pages each (of the
// table, or of the window's pages), covering them; with splits > 1, ws
// holds batch * hkv * qblocks * splits * group * (head_dim + 2) floats and
// arrivals batch * hkv * qblocks ints, zero before the first call (the
// kernel leaves them zero). The caller has checked shapes, contiguity and
// 16-byte alignment.
extern "C" int tfa_paged_decode(const void* q, const void* pages,
                                const void* lengths, const void* page_indices,
                                int pi_stride, int pages_per_seq, int splits,
                                int pages_per_split, void* out, void* lse,
                                void* ws, void* arrivals, int batch, int hq,
                                int hkv, int qblocks, int num_pages,
                                int page_size, int page_rows, int head_dim,
                                int window, float scale_log2, int dtype,
                                int quantized, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return (int)fused_decode<__nv_bfloat16, false>(
      q, pages, lengths, page_indices, pi_stride, pages_per_seq, splits,
      pages_per_split, out, lse, ws, arrivals, batch, hq, hkv, qblocks,
      num_pages, page_size, page_rows, head_dim, window, scale_log2,
      quantized, static_cast<cudaStream_t>(stream));
}
