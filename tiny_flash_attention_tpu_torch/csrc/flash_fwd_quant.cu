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
// bf16 q: the instances FMT kInt8 / kE4m3 of B1's wgmma/TMA kernel
// (flash_fwd_wgmma.cuh), on B1's 128-row tiles (at head_dim 256 its wide
// instance's 64-row kv tiles in two stages): its producer warpgroup
// bulk-copies each payload tile into its ring stage and expands it in place
// into the swizzled bf16 tile, so the S and PV products are B1's own; the
// consumers fold the scales around them.
// What bounds it: the tensor-core FLOPs at prefill shapes, as for B1 (the
// K/V bytes halve, the operations do not); the conversion is the
// producer's, two payload bytes an instruction, beside the consumers'
// work. f32 q: the CUDA-core body of flash_fwd.cuh on FLASH_FWD_F32's
// tiles and kv runs (at head_dim 256 FLASH_FWD_F32_WIDE's), each tile's
// payload bytes loaded into registers a step ahead and converted to f32
// exactly into its ring stage. Every
// option of B1 but the jagged mode (JAX's row loop has no quantized
// operands).

#include "flash_fwd_wgmma.cuh"

namespace {

// One launch over K/V of payload format FMT, for q's dtype (0 bf16, 1 f32)
// and head_dim (64, 128 or 256); cudaErrorInvalidValue for any other.
template <int FMT>
cudaError_t launch_quant(const void* q, const void* k, const void* v,
                         void* o, void* lse, const FwdMasks& mk,
                         const KvScales& sc, const F32Runs& runs,
                         int batch, int hq, int hkv,
                         int q_len, int kv_len, int head_dim, int causal,
                         int window, float scale_log2, int dtype,
                         cudaStream_t s) {
  const QuantKv qk{static_cast<const uint8_t*>(k),
                   static_cast<const uint8_t*>(v), sc.k, sc.v, sc.ld};
  const auto launch = [&](auto width) {
    constexpr int D = decltype(width)::value;
    return dtype == 0
               ? launch_wgmma_fwd<D, FMT>(q, k, v, o, lse, mk, qk, batch, hq,
                                          hkv, q_len, kv_len, D, causal,
                                          window, scale_log2, s)
               : launch_f32<D, FMT>(q, k, v, o, lse, mk, sc, runs, batch, hq,
                                    hkv, q_len, kv_len, causal, window,
                                    scale_log2, s);
  };
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (head_dim) {
    case 64: return launch(std::integral_constant<int, 64>());
    case 128: return launch(std::integral_constant<int, 128>());
    case 256: return launch(std::integral_constant<int, 256>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. fmt: 1 int8, 2 e4m3
// (k and v alike); k_scales, v_scales: (B, hkv, scale_ld) f32, not null,
// scale_ld at least kv_len rounded up to a whole 128-column tile (a tile's
// columns are read without a bound).
// dtype (of q and out): 0 bf16, 1 f32. head_dim: 64, 128 or 256. q_seg,
// kv_seg, tile_lo and tile_order as in tfa_flash_fwd (one int per q tile of
// the bf16 instance's tiles, ops/flash.py::fwd_config); work, partials,
// arrivals and n_items the f32 instance's, as in tfa_flash_fwd; window: 0
// for none, else >= 1 with causal. The caller has checked shapes,
// contiguity and alignment.
extern "C" int tfa_flash_fwd_quant(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_seg, const void* kv_seg, const void* tile_lo,
    const void* tile_order, const void* k_scales, const void* v_scales,
    const void* work, void* partials, void* arrivals, int scale_ld,
    int batch, int hq, int hkv, int q_len, int kv_len, int head_dim,
    int causal, int window, int n_items, float scale_log2, int fmt,
    int dtype, void* stream) {
  if (!fwd_args_valid(batch, hq, hkv, q_len, kv_len, q_seg, kv_seg, nullptr,
                      causal, window) ||
      k_scales == nullptr || v_scales == nullptr ||
      scale_ld < (kv_len + FwdTiles<128>::BN - 1) / FwdTiles<128>::BN *
                     FwdTiles<128>::BN)
    return (int)cudaErrorInvalidValue;
  const FwdMasks mk{static_cast<const int*>(q_seg),
                    static_cast<const int*>(kv_seg),
                    static_cast<const int*>(tile_lo),
                    static_cast<const int*>(tile_order), nullptr};
  const KvScales sc{static_cast<const float*>(k_scales),
                    static_cast<const float*>(v_scales), scale_ld};
  const F32Runs runs{static_cast<const int*>(work), n_items,
                     static_cast<float*>(partials),
                     static_cast<int*>(arrivals)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fmt == kInt8)
    return (int)launch_quant<kInt8>(q, k, v, o, lse, mk, sc, runs, batch, hq,
                                    hkv, q_len, kv_len, head_dim, causal,
                                    window, scale_log2, dtype, s);
  if (fmt == kE4m3)
    return (int)launch_quant<kE4m3>(q, k, v, o, lse, mk, sc, runs, batch, hq,
                                    hkv, q_len, kv_len, head_dim, causal,
                                    window, scale_log2, dtype, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block of the quantized instance for dtype
// (0 bf16, 1 f32) and head_dim (64, 128 or 256) takes, either payload
// format (bf16: B1's layout with its payload-copy barriers, FwdSmem); -1
// for any other. ops/flash.py holds
// ops/configs.py::fwd_smem_bytes to it when it loads this library.
extern "C" int tfa_flash_fwd_quant_smem(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 256) return FwdSmem<256, true>::ALLOC;
  if (dtype == 0 && head_dim == 128) return FwdSmem<128, true>::ALLOC;
  if (dtype == 0 && head_dim == 64) return FwdSmem<64, true>::ALLOC;
  if (dtype == 1 && head_dim == 256) return f32_smem_bytes<256, kInt8>();
  if (dtype == 1 && head_dim == 128) return f32_smem_bytes<128, kInt8>();
  if (dtype == 1 && head_dim == 64) return f32_smem_bytes<64, kInt8>();
  return -1;
}
