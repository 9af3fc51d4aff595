// Flash-attention-2 forward for Hopper (sm_90a) over K/V in q's dtype: the
// entry of the unquantized instances. bf16 runs the wgmma/TMA kernel of
// flash_fwd_wgmma.cuh (which flash_fwd_quant.cu instantiates over int8/e4m3
// payloads too), f32 the CUDA-core kernel of flash_fwd.cuh.
//
// Replaces the three TPU forward kernels
//   tiny_flash_attention_tpu/ops/flash.py::_flash_fwd_impl      (_fwd_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_flash_fwd    (_tri_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_block_fwd    (_tri_block_kernel)
// and, in its jagged mode, the row-loop forward
//   tiny_flash_attention_tpu/ops/flash_rowloop.py::flash_attention_rowloop
// for K/V in q's dtype. The contract and every mask are those of
// flash_fwd.cuh; what bounds the bf16 kernel and its design are in
// flash_fwd_wgmma.cuh, the f32 kernel's in flash_fwd.cuh.

#include "flash_fwd_wgmma.cuh"

// Returns a cudaError_t: 0 when the kernel was launched. dtype: 0 bf16,
// 1 f32. head_dim: bf16 any multiple of 8 up to 512, read and written at
// its true width by the instance flash_width(head_dim, narrow) picks
// (hopper.cuh: 64, 80, 96, 128, 256 or 512; narrow 0 takes 64, 128, 256 or
// 512); f32
// 64, 128 or 256 (the wide instance's tiles, F32Tiles<256>). q_seg,
// kv_seg, tile_lo, tile_order and seq_lens may each be null (FwdMasks);
// tile_lo and tile_order hold one int per q tile of the bf16 instance's
// tiles (the wide instance's kv tiles are 64 rows, the 512 instance's q
// tiles 64 and kv tiles 32: their tile_lo counts those; the f32 instance takes neither: its work list holds the pruned
// ranges and their order). work,
// n_items, partials, arrivals: the f32 instance's runs and merge workspace
// (F32Runs in flash_fwd.cuh; ops/flash.py::fwd_f32_work), unused in bf16.
// window: 0 for none, else >= 1 with causal and without seq_lens. The
// caller has checked shapes, contiguity and 16-byte alignment. A bf16
// launch whose tensor maps cannot be encoded returns cudaErrorInvalidValue.
extern "C" int tfa_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* q_seg,
                             const void* kv_seg, const void* tile_lo,
                             const void* tile_order, const void* seq_lens,
                             const void* work, void* partials,
                             void* arrivals, int batch, int hq, int hkv,
                             int q_len, int kv_len, int head_dim,
                             int causal, int window, int n_items,
                             float scale_log2, int dtype, int narrow,
                             void* stream) {
  if (!fwd_args_valid(batch, hq, hkv, q_len, kv_len, q_seg, kv_seg, seq_lens,
                      causal, window))
    return (int)cudaErrorInvalidValue;
  const FwdMasks mk{static_cast<const int*>(q_seg),
                    static_cast<const int*>(kv_seg),
                    static_cast<const int*>(tile_lo),
                    static_cast<const int*>(tile_order),
                    static_cast<const int*>(seq_lens)};
  const KvScales none{nullptr, nullptr, 0};
  const F32Runs runs{static_cast<const int*>(work), n_items,
                     static_cast<float*>(partials),
                     static_cast<int*>(arrivals)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const QuantKv bf16_kv{nullptr, nullptr, nullptr, nullptr, 0};
  if (dtype == 0) {
    const auto launch = [&](auto width) {
      return (int)launch_wgmma_fwd<decltype(width)::value, kNone>(
          q, k, v, o, lse, mk, bf16_kv, batch, hq, hkv, q_len, kv_len,
          head_dim, causal, window, scale_log2, s);
    };
    switch (flash_width(head_dim, narrow)) {
      case 64: return launch(std::integral_constant<int, 64>());
      case 80: return launch(std::integral_constant<int, 80>());
      case 96: return launch(std::integral_constant<int, 96>());
      case 128: return launch(std::integral_constant<int, 128>());
      case 256: return launch(std::integral_constant<int, 256>());
      case 512: return launch(std::integral_constant<int, 512>());
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const auto launch = [&](auto width) {
    return (int)launch_f32<decltype(width)::value, kNone>(
        q, k, v, o, lse, mk, none, runs, batch, hq, hkv, q_len, kv_len,
        causal, window, scale_log2, s);
  };
  switch (head_dim) {
    case 64: return launch(std::integral_constant<int, 64>());
    case 128: return launch(std::integral_constant<int, 128>());
    case 256: return launch(std::integral_constant<int, 256>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory one block of the instance for dtype (0 bf16,
// 1 f32) and head_dim (64, 128 or 256: the tiles' columns, which the bf16
// instances of width 80 and 96 share with 128; bf16 also 512) takes; -1 for
// any
// other. ops/flash.py holds ops/configs.py::fwd_smem_bytes to it when it
// loads this library.
extern "C" int tfa_flash_fwd_smem(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 512) return FwdSmem<512, false>::ALLOC;
  if (dtype == 0 && head_dim == 256) return FwdSmem<256, false>::ALLOC;
  if (dtype == 0 && head_dim == 128) return FwdSmem<128, false>::ALLOC;
  if (dtype == 0 && head_dim == 64) return FwdSmem<64, false>::ALLOC;
  if (dtype == 1 && head_dim == 256) return f32_smem_bytes<256, kNone>();
  if (dtype == 1 && head_dim == 128) return f32_smem_bytes<128, kNone>();
  if (dtype == 1 && head_dim == 64) return f32_smem_bytes<64, kNone>();
  return -1;
}
