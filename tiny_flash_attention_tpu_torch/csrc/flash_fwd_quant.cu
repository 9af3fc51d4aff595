// Flash-attention-2 forward for Hopper (sm_90a) over a quantized KV cache:
// int8 or fp8-e4m3 K/V payloads with per-token f32 scales.
//
// Replaces the quantized mode of the TPU forward kernels
//   tiny_flash_attention_tpu/ops/flash.py::_flash_fwd_impl      (_fwd_kernel,
//       k_scales / v_scales: flash.py:268-273, :336-341, :469-481)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_flash_fwd    (_tri_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_block_fwd    (_tri_block_kernel)
// behind tiny_flash_attention_tpu/ops/flash_quant.py::flash_attention_quantized.
//
// The kernels are the mma.sync bodies of flash_fwd.cuh with FMT kInt8 or
// kE4m3 (B1's bf16 instances are flash_fwd.cu's wgmma/TMA kernel): the
// cp.async ring carries payload rows (half a bf16 row's bytes) and their
// scales; each landed tile is converted in shared memory into a bf16 (f32)
// tile of the unquantized layout, so the S and PV products are the
// unquantized ones. The scales fold around them: s *= kscale before the
// mask, l from the bare p, p *= vscale before its one rounding. What bounds
// it: the tensor-core FLOPs at prefill shapes, as for B1 (the K/V bytes
// halve, the operations do not); the convert pass adds shared-memory
// traffic and one barrier a tile, the price of the simplest right design.
// On wgmma the converted tile would have to be written back to shared
// memory in the swizzled layout, through a stage of its own (wgmma reads
// its B operand, K in S and V in PV, from there). Every option of B1 but
// the jagged mode (JAX's row loop has no quantized operands). Tile sizes:
// ops/configs.py FLASH_FWD_QUANT_BF16 (bf16 q) and FLASH_FWD_F32 (f32 q).

#include "flash_fwd.cuh"

// Returns a cudaError_t: 0 when the kernel was launched. fmt: 1 int8, 2 e4m3
// (k and v alike); k_scales, v_scales: (B, hkv, kv_len) f32, not null.
// dtype (of q and out): 0 bf16, 1 f32. head_dim: 64 or 128. q_seg, kv_seg,
// tile_lo and tile_order as in tfa_flash_fwd (one int per q tile of this
// instance's block_m, ops/flash.py::fwd_config); window: 0 for none, else >= 1
// with causal. The caller has checked shapes, contiguity and alignment.
extern "C" int tfa_flash_fwd_quant(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_seg, const void* kv_seg, const void* tile_lo,
    const void* tile_order, const void* k_scales, const void* v_scales,
    int batch, int hq, int hkv, int q_len, int kv_len, int head_dim,
    int causal, int window, float scale_log2, int fmt, int dtype,
    void* stream) {
  if (!fwd_args_valid(batch, hq, hkv, q_len, kv_len, q_seg, kv_seg, nullptr,
                      causal, window) ||
      k_scales == nullptr || v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  const FwdMasks mk{static_cast<const int*>(q_seg),
                    static_cast<const int*>(kv_seg),
                    static_cast<const int*>(tile_lo),
                    static_cast<const int*>(tile_order), nullptr};
  const KvScales sc{static_cast<const float*>(k_scales),
                    static_cast<const float*>(v_scales)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kInt8)
    return (int)launch_fwd<kInt8>(q, k, v, o, lse, mk, sc, batch, hq, hkv,
                                  q_len, kv_len, head_dim, causal, window,
                                  scale_log2, dtype, s);
  if (fmt == kE4m3)
    return (int)launch_fwd<kE4m3>(q, k, v, o, lse, mk, sc, batch, hq, hkv,
                                  q_len, kv_len, head_dim, causal, window,
                                  scale_log2, dtype, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block of the quantized instance for dtype
// (0 bf16, 1 f32) and head_dim (64 or 128) takes, either payload format;
// -1 for any other. ops/flash.py holds ops/configs.py::fwd_smem_bytes to it
// when it loads this library.
extern "C" int tfa_flash_fwd_quant_smem(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 128) return bf16_quant_smem_bytes<128>();
  if (dtype == 0 && head_dim == 64) return bf16_quant_smem_bytes<64>();
  if (dtype == 1 && head_dim == 128) return f32_smem_bytes<128, kInt8>();
  if (dtype == 1 && head_dim == 64) return f32_smem_bytes<64, kInt8>();
  return -1;
}
