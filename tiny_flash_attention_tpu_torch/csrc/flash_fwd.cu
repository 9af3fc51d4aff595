// Flash-attention-2 forward for Hopper (sm_90a), over bf16 or f32 K/V.
//
// Replaces the three TPU forward kernels
//   tiny_flash_attention_tpu/ops/flash.py::_flash_fwd_impl      (_fwd_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_flash_fwd    (_tri_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_block_fwd    (_tri_block_kernel)
// and, in its jagged mode, the row-loop forward
//   tiny_flash_attention_tpu/ops/flash_rowloop.py::flash_attention_rowloop
// for K/V in q's dtype. The kernels, their design and what bounds them are in
// flash_fwd.cuh; this source instantiates them without quantized operands
// (flash_fwd_quant.cu holds the int8/e4m3 instances).

#include "flash_fwd.cuh"

// Returns a cudaError_t: 0 when the kernel was launched. dtype: 0 bf16,
// 1 f32. head_dim: 64 or 128. q_seg, kv_seg, tile_lo, tile_order and
// seq_lens may each be null (FwdMasks); tile_lo and tile_order hold one
// int per q tile of this dtype's block_m. window: 0 for none, else >= 1
// with causal and without seq_lens. The caller has checked shapes,
// contiguity and 16-byte alignment.
extern "C" int tfa_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* q_seg,
                             const void* kv_seg, const void* tile_lo,
                             const void* tile_order, const void* seq_lens,
                             int batch, int hq, int hkv, int q_len,
                             int kv_len, int head_dim, int causal,
                             int window, float scale_log2, int dtype,
                             void* stream) {
  if (!fwd_args_valid(batch, hq, hkv, q_len, kv_len, q_seg, kv_seg, seq_lens,
                      causal, window))
    return (int)cudaErrorInvalidValue;
  const FwdMasks mk{static_cast<const int*>(q_seg),
                    static_cast<const int*>(kv_seg),
                    static_cast<const int*>(tile_lo),
                    static_cast<const int*>(tile_order),
                    static_cast<const int*>(seq_lens)};
  return (int)launch_fwd<kNone>(q, k, v, o, lse, mk, KvScales{nullptr, nullptr},
                                batch, hq, hkv, q_len, kv_len, head_dim,
                                causal, window, scale_log2, dtype,
                                static_cast<cudaStream_t>(stream));
}
