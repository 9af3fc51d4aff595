// One-token GQA decode attention over fused KV pages, for Hopper (sm_90a).
//
// Replaces tiny_flash_attention_tpu/ops/paged_fused.py::
// fused_paged_decode_attention (_fused_decode_kernel) for bf16 (and f32)
// pages and for int8 pages with bit-packed f32 scale rows, with and without
// its sliding-window ring mode. The kernel, its design and what bounds it are
// in paged_decode.cuh; this source instantiates it over fused pages.

#include "paged_decode.cuh"

namespace {

template <typename T, typename P, int D>
cudaError_t launch_fused(int group, const void* q, const void* pages,
                         const void* lengths, const void* page_indices,
                         int pi_stride, int pages_per_seq, int splits,
                         int pages_per_split, void* out, void* lse, void* ws,
                         void* arrivals, int batch, int hkv, int qblocks,
                         int num_pages, int page_size, int page_rows,
                         int window, float scale_log2, cudaStream_t stream) {
  const FusedPages<P, D> layout{static_cast<const P*>(pages), num_pages,
                                page_size, page_rows};
  if (window > 0)
    return launch_group<T, P, D, true>(
        group, q, layout, lengths, page_indices, pi_stride, pages_per_seq,
        splits, pages_per_split, out, lse, ws, arrivals, batch, hkv, qblocks,
        window, scale_log2, stream);
  return launch_group<T, P, D, false>(
      group, q, layout, lengths, page_indices, pi_stride, pages_per_seq,
      splits, pages_per_split, out, lse, ws, arrivals, batch, hkv, qblocks,
      0, scale_log2, stream);
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. dtype (of q and
// out): 0 bf16, 1 f32; quantized: 0 pages of q's dtype with page_rows =
// 2 * page_size, 1 int8 pages with page_rows = 2 * page_size + 2 * sr.
// head_dim: 64, 80, 96 or 128, and 256 with bf16 q; hq = hkv * qblocks *
// group, group 1, 2, 4 or 8 q rows a block (at most 4 at 256), qblocks
// blocks of them a kv head (the caller pads the q heads); page_size 16 or
// a multiple of 32. window: 0 for none, else the ring mode over [length -
// window, length), window <= P * ps. splits
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
  if (batch <= 0 || hkv <= 0 || qblocks <= 0 || hq % (hkv * qblocks) != 0 ||
      page_size <= 0 || (page_size != 16 && page_size % 32) ||
      pages_per_seq <= 0 ||
      window < 0 || window > pages_per_seq * page_size || splits < 1 ||
      pages_per_split < 1 ||
      (splits > 1 && (ws == nullptr || arrivals == nullptr)) ||
      (quantized ? page_rows <= 2 * page_size : page_rows != 2 * page_size))
    return (int)cudaErrorInvalidValue;
  const int group = hq / (hkv * qblocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFA_DECODE_ARGS                                                      \
  group, q, pages, lengths, page_indices, pi_stride, pages_per_seq,        \
      splits, pages_per_split, out, lse, ws, arrivals, batch, hkv, qblocks, \
      num_pages, page_size, page_rows, window, scale_log2, s
#define TFA_DECODE_DISPATCH(T, P)                                            \
  if (head_dim == 128) return (int)launch_fused<T, P, 128>(TFA_DECODE_ARGS); \
  if (head_dim == 64) return (int)launch_fused<T, P, 64>(TFA_DECODE_ARGS);   \
  if (head_dim == 96) return (int)launch_fused<T, P, 96>(TFA_DECODE_ARGS);   \
  if (head_dim == 80) return (int)launch_fused<T, P, 80>(TFA_DECODE_ARGS);   \
  return (int)cudaErrorInvalidValue
  if (dtype == 0 && !quantized) {
    if (head_dim == 256)
      return (int)launch_fused<__nv_bfloat16, __nv_bfloat16, 256>(
          TFA_DECODE_ARGS);
    TFA_DECODE_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  }
  if (dtype == 0 && quantized) {
    if (head_dim == 256)
      return (int)launch_fused<__nv_bfloat16, int8_t, 256>(
          TFA_DECODE_ARGS);
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
