// Flash-attention-2 forward for Hopper (sm_90a) on the CUDA cores: the f32
// kernel body (f32 q over f32 K/V, flash_fwd.cu, and over int8/e4m3 K/V
// with per-token scales, flash_fwd_quant.cu) and the contract, masks and
// helpers that every forward instance shares. bf16 q runs the wgmma/TMA
// kernel of flash_fwd_wgmma.cuh, over bf16 K/V and over the payloads alike.
//
// Replaces the three TPU forward kernels, which compute one contract and
// differ only in TPU scheduling (VMEM residency, work lists, the triangle
// decomposition):
//   tiny_flash_attention_tpu/ops/flash.py::_flash_fwd_impl      (_fwd_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_flash_fwd    (_tri_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_block_fwd    (_tri_block_kernel)
//
// and, in its jagged mode, the row-loop forward
//   tiny_flash_attention_tpu/ops/flash_rowloop.py::flash_attention_rowloop
//                                                               (_rowloop_kernel)
//
// Contract: q (B, hq, Sq, D), k/v (B, hkv, Skv, D), contiguous; q head h reads
// kv head h / (hq / hkv). Causal rows sit at position row + Skv - Sq. Returns
// out like q and a natural-log LSE (B, hq, Sq) in f32. The mask value is
// -0.7 * FLT_MAX, never -inf; a row with no visible column gets output 0 and
// LSE m * ln2 (the TPU kernels' empty-row guard and sentinel). Optional
// inputs (FwdMasks, each off when null; the window, off when 0):
//   * segment ids q_seg (B, Sq), kv_seg (B, Skv): only equal ids attend. Ids
//     are runtime values, so with them every tile pays the mask (JAX's
//     any_masked = ... or with_segments); the KV ids of a tile ride the
//     ring beside its K rows.
//   * tile_lo (n q tiles): the first kv tile of each q tile, from the static
//     segment_starts of a packed row (the segment start of the tile's first
//     row, JAX's _build_worklist): the kv loop runs [lo, hi), so a packed
//     prefill costs sum(L_i^2)/2, not (sum L_i)^2/2. The table is built for
//     the instance's own q and kv tile sizes (ops/flash.py::SegmentTiles).
//   * tile_order (n q tiles): the q tile each blockIdx.x takes. The host
//     knows the pruned work of every tile (the starts are static), so it
//     hands the grid out longest work first.
//   * window (> 0, causal): the sliding window; the row at position p sees
//     columns [p - window + 1, p]. A q tile's kv loop starts at the tile of
//     its first row's left edge (with every q tile doing about the same
//     work, the reversed grid order below is harmless), and only tiles that
//     straddle the band's left edge pay the extra compare. It composes with
//     the decode offset, segment ids and tile_lo; not with seq_lens. Whether
//     there is a window is a template parameter, so a launch without one
//     pays no test of it (a runtime test cost such launches 6-16 % on the
//     H100, most where every tile is masked).
//   * seq_lens (B): the jagged mode (q_len == kv_len, causal; unquantized
//     K/V only). Row b's columns and rows at or past L = seq_lens[b] are out:
//     the kv walk clamps to min(last row, L - 1), columns >= L are masked,
//     rows >= L are empty rows (out 0, the sentinel), and a q tile that
//     starts at or past L writes them and exits. The row-loop TPU kernel's
//     point, a KV walk inside one grid step with a dynamic trip count, is
//     how every block here already works; its jagged lengths are one more
//     bound on that walk, so B11 is this mode of the B1 kernel (as B2 and B3
//     are B1), not a second kernel. The grid keeps the reversed order below:
//     the lengths are runtime values, and blocks past L cost a store and an
//     exit.
//
// Quantized K/V (FMT kInt8 or kE4m3, the quantized instances of
// flash_fwd_quant.cu; every option above but seq_lens): k/v are 1-byte
// payloads with per-token f32 scales (B, hkv, ld), folded as the TPU kernels
// fold them (flash.py:268-273, :336-341): s *= kscale of its column before
// the mask, so a masked entry stays exactly the mask value; l sums the bare
// p; only the p that goes into the PV product is multiplied by vscale of its
// column, in f32, before its one rounding. int8 converts exactly; e4m3 to
// bf16 repeats the TPU kernels' integer mapping (flash.py:59-80: the
// subnormal codes land high, the NaN codes give +/-480), e4m3 to f32 is
// exact (JAX's astype).
//
// The f32 kernel computes in real f32 FMAs on the CUDA cores (never TF32;
// the f32 gate is 2e-5): 256 threads, each owning a 4 x 4 piece of the
// 64 x 64 score tile and a 4 x D/16 piece of the output; quantized, each
// tile's payload bytes are converted to f32 as they are staged. What bounds
// it: the f32 FMAs (4 * D per visible pair and q head at 67 TF/s). Blocks
// run longest causal rows first (tile_order's longest pruned work first
// with segment_starts).
//
// Tile sizes come from tiny_flash_attention_tpu_torch/ops/configs.py as -D
// defines (FLASH_FWD_F32); the build refuses to compile without them.

#pragma once

#include <type_traits>

#include "flash_common.cuh"

#if !defined(TFA_FWD_F32_BLOCK_M) || !defined(TFA_FWD_F32_BLOCK_N) || \
    !defined(TFA_FWD_F32_THREADS)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

// Optional inputs of one launch; a null pointer turns its feature off.
struct FwdMasks {
  const int* q_seg;       // (B, q_len) segment ids, with kv_seg
  const int* kv_seg;      // (B, kv_len)
  const int* tile_lo;     // (n q tiles) first kv tile of each q tile
  const int* tile_order;  // (n q tiles) q tile of each blockIdx.x
  const int* seq_lens;    // (B) jagged lengths, q_len == kv_len
};

// K/V payload formats: kNone the inputs in q's dtype, kInt8 and kE4m3 1-byte
// payloads with per-token scales.
enum PayloadFormat : int { kNone = 0, kInt8 = 1, kE4m3 = 2 };

// The per-token scales of quantized K/V, (B, hkv, ld) f32 with ld >= kv_len;
// null for kNone.
struct KvScales {
  const float* k;
  const float* v;
  int ld;
};

// The element type of k and v: q's dtype, or a payload byte.
template <int FMT, typename T>
using KvElem = std::conditional_t<FMT == kNone, T, uint8_t>;

// The first kv tile of a windowed q tile whose first row sits at position
// `pos`: `lo`, or the tile of the row's window edge where that is later;
// never past the last tile hi - 1.
__device__ __forceinline__ int window_lo(int lo, int hi, int pos, int window,
                                         int bn) {
  const int left = pos - window + 1;
  return left > 0 ? max(lo, min(left / bn, hi - 1)) : lo;
}

// Rows [q0, q0 + rows) as empty rows: out 0, LSE the sentinel m * ln2 of a
// row whose running max stayed at the mask value. Zero is all-zero bits in
// bf16 and f32, and a row of D = 64 or 128 elements is whole 16-byte stores.
template <typename T, int D>
__device__ void write_empty_rows(T* og, float* lg, int q0, int rows) {
  uint4* dst = reinterpret_cast<uint4*>(og + (size_t)q0 * D);
  const int n = rows * D * (int)sizeof(T) / 16;
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    dst[c] = make_uint4(0u, 0u, 0u, 0u);
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    lg[q0 + r] = kMaskValue * kLn2;
}

// ------------------------------------------------------- payload converts

// One payload byte as f32, exactly (e4m3: JAX's astype; 0x7F/0xFF are NaN).
template <int FMT>
__device__ __forceinline__ float payload_f32(uint32_t u) {
  if constexpr (FMT == kInt8) {
    return (float)(int)(int8_t)(uint8_t)u;
  } else {
    const uint32_t mag = u & 0x7Fu;
    float x;
    if (mag == 0x7Fu)
      x = __uint_as_float(0x7FC00000u);
    else if (mag < 8u)
      x = (float)mag * 0.001953125f;  // subnormal: mantissa * 2^-9
    else
      x = __uint_as_float((mag << 20) + (120u << 23));
    return __uint_as_float(__float_as_uint(x) | ((u & 0x80u) << 24));
  }
}

// Four payload bytes (one 32-bit word, the lowest byte first) as f32.
template <int FMT>
__device__ __forceinline__ float4 payload4_f32(uint32_t w) {
  return make_float4(payload_f32<FMT>(w & 0xFFu),
                     payload_f32<FMT>((w >> 8) & 0xFFu),
                     payload_f32<FMT>((w >> 16) & 0xFFu),
                     payload_f32<FMT>(w >> 24));
}

// ----------------------------------------------------------------- f32 path

constexpr int FM = TFA_FWD_F32_BLOCK_M;
constexpr int FN = TFA_FWD_F32_BLOCK_N;
constexpr int FTHREADS = TFA_FWD_F32_THREADS;
// thread t owns rows (t / 16) * 4 + [0, 4) and columns t % 16 + 16 * [0, n)
static_assert(FM == 64 && FN == 64 && FTHREADS == 256,
              "the f32 thread map is 16 x 16 threads over a 64 x 64 tile");

// Dynamic shared memory of an f32 block: q^T, k^T, v, p (rows padded by
// one) and the kv ids; quantized, the tile's k and v scales too
// (ops/configs.py::fwd_smem_bytes mirrors it; tfa_flash_fwd_smem and
// tfa_flash_fwd_quant_smem export it).
template <int D, int FMT>
constexpr int f32_smem_bytes() {
  return (D * FM + D * FN + FN * D + FM * (FN + 1)) * (int)sizeof(float) +
         FN * (int)sizeof(int) +
         (FMT == kNone ? 0 : 2 * FN * (int)sizeof(float));
}

template <int D, bool WINDOW, int FMT>
__global__ void __launch_bounds__(FTHREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const KvElem<FMT, float>* __restrict__ k,
                         const KvElem<FMT, float>* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ lse,
                         FwdMasks mk, KvScales sc, int hq, int hkv,
                         int q_len, int kv_len, int causal, float scale_log2,
                         int window) {
  constexpr bool QUANT = FMT != kNone;
  constexpr int PS = FN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [D][FM], q^T, scaled
  float* kt = qt + D * FM;                         // [D][FN], k^T
  float* vs = kt + D * FN;                         // [FN][D]
  float* ps = vs + FN * D;                         // [FM][PS]
  int* kid = reinterpret_cast<int*>(ps + FM * PS);  // [FN] kv ids
  // quantized: the tile's k and v scales [FN] each
  float* ksc = reinterpret_cast<float*>(kid + FN);
  float* vsc = ksc + FN;

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int q0 = (mk.tile_order ? mk.tile_order[blockIdx.x]
                                : gridDim.x - 1 - blockIdx.x) * FM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int offset = kv_len - q_len;
  const float* qg = q + (size_t)(b * hq + h) * q_len * D;
  const auto* kg = k + (size_t)(b * hkv + kvh) * kv_len * D;
  const auto* vg = v + (size_t)(b * hkv + kvh) * kv_len * D;
  float* og = o + (size_t)(b * hq + h) * q_len * D;
  float* lg = lse + (size_t)(b * hq + h) * q_len;
  const bool segs = mk.q_seg != nullptr;
  const int col_end =
      mk.seq_lens ? min(max(mk.seq_lens[b], 0), kv_len) : kv_len;
  const int row_end = mk.seq_lens ? col_end : q_len;
  if (q0 >= row_end) {
    write_empty_rows<float, D>(og, lg, q0, min(FM, q_len - q0));
    return;
  }
  const int hi = min(kv_tiles(q0, FM, q_len, kv_len, causal, FN),
                     (col_end + FN - 1) / FN);
  int lo = mk.tile_lo ? max(0, min(mk.tile_lo[q0 / FM], hi - 1)) : 0;
  if (WINDOW) lo = window_lo(lo, hi, q0 + offset, window, FN);
  const bool mask_all = segs || (mk.seq_lens && q0 + FM > row_end);
  const int* kv_ids = segs ? mk.kv_seg + (size_t)b * kv_len : nullptr;
  int qid[4] = {0, 0, 0, 0};
  if (segs) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      if (row < q_len) qid[i] = mk.q_seg[(size_t)b * q_len + row];
    }
  }

  for (int c = tid; c < FM * D / 4; c += FTHREADS) {
    const int r = c % FM, col = (c / FM) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < q_len)
      x = *reinterpret_cast<const float4*>(qg + (size_t)(q0 + r) * D + col);
    qt[(col + 0) * FM + r] = x.x * scale_log2;
    qt[(col + 1) * FM + r] = x.y * scale_log2;
    qt[(col + 2) * FM + r] = x.z * scale_log2;
    qt[(col + 3) * FM + r] = x.w * scale_log2;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int t = lo; t < hi; ++t) {
    const int kv0 = t * FN;
    __syncthreads();  // previous tile's kt / vs / ps are no longer read
    for (int c = tid; c < FN * D / 4; c += FTHREADS) {
      const int r = c % FN, col = (c / FN) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kv0 + r < kv_len) {
        if constexpr (QUANT) {
          // four payload bytes, converted to f32
          const size_t at = (size_t)(kv0 + r) * D + col;
          kx = payload4_f32<FMT>(*reinterpret_cast<const uint32_t*>(kg + at));
          vx = payload4_f32<FMT>(*reinterpret_cast<const uint32_t*>(vg + at));
        } else {
          kx = *reinterpret_cast<const float4*>(kg + (size_t)(kv0 + r) * D + col);
          vx = *reinterpret_cast<const float4*>(vg + (size_t)(kv0 + r) * D + col);
        }
      }
      kt[(col + 0) * FN + r] = kx.x;
      kt[(col + 1) * FN + r] = kx.y;
      kt[(col + 2) * FN + r] = kx.z;
      kt[(col + 3) * FN + r] = kx.w;
      *reinterpret_cast<float4*>(vs + r * D + col) = vx;
    }
    if (segs) {
      for (int r = tid; r < FN; r += FTHREADS)
        kid[r] = kv0 + r < kv_len ? kv_ids[kv0 + r] : 0;
    }
    if constexpr (QUANT) {
      const size_t head = (size_t)(b * hkv + kvh) * sc.ld;
      for (int r = tid; r < FN; r += FTHREADS) {
        const bool valid = kv0 + r < kv_len;
        ksc[r] = valid ? sc.k[head + kv0 + r] : 0.f;
        vsc[r] = valid ? sc.v[head + kv0 + r] : 0.f;
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 qv = *reinterpret_cast<const float4*>(qt + kk * FM + rg * 4);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = kt[kk * FN + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qr[i], kv, s[i][j]);
      }
    }

    if constexpr (QUANT) {  // s *= kscale of its column, before the mask
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = ksc[cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] *= f;
      }
    }

    if (mask_all || kv0 + FN > col_end ||
        (causal && kv0 + FN - 1 > q0 + offset) ||
        (WINDOW && kv0 < q0 + FM + offset - window)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = kv0 + cg + 16 * j, row = q0 + rg * 4 + i;
          const bool ok = col < col_end && row < row_end &&
                          (!causal || col <= row + offset) &&
                          (!WINDOW || col > row + offset - window) &&
                          (!segs || qid[i] == kid[cg + 16 * j]);
          if (!ok) s[i][j] = kMaskValue;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float alpha = exp2f(m_run[i] - mx);
      const float keep = mx > 0.5f * kMaskValue ? 1.f : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - mx) * keep;
        rs += p;
        // quantized: l sums the bare p, PV takes p * vscale of its column
        if constexpr (QUANT)
          ps[(rg * 4 + i) * PS + cg + 16 * j] = p * vsc[cg + 16 * j];
        else
          ps[(rg * 4 + i) * PS + cg + 16 * j] = p;
      }
      l_run[i] = alpha * l_run[i] + rs;
      m_run[i] = mx;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < FN; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(rg * 4 + i) * PS + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float vv = vs[kk * D + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    const float l_safe = (l == 0.f || l != l) ? 1.f : l;
    const int row = q0 + rg * 4 + i;
    if (row < q_len) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        og[(size_t)row * D + cg + 16 * j] = acc[i][j] / l_safe;
      if (cg == 0) lg[row] = m_run[i] * kLn2 + logf(l_safe);
    }
  }
}

template <int D, int FMT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, const FwdMasks& mk, const KvScales& sc,
                       int batch, int hq, int hkv, int q_len, int kv_len,
                       int causal, int window, float scale_log2,
                       cudaStream_t stream) {
  const int smem = f32_smem_bytes<D, FMT>();
  using KV = KvElem<FMT, float>;
  const bool windowed = window > 0;
  const auto kernel = windowed ? flash_fwd_f32_kernel<D, true, FMT>
                               : flash_fwd_f32_kernel<D, false, FMT>;
  static bool smem_set[2][kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(kernel, smem, smem_set[windowed]);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + FM - 1) / FM, hq, batch);
  kernel<<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), mk, sc, hq, hkv, q_len, kv_len, causal,
      scale_log2, window);
  return cudaGetLastError();
}

// Checks one launch's arguments shared by both entries; true when valid.
inline bool fwd_args_valid(int batch, int hq, int hkv, int q_len, int kv_len,
                           const void* q_seg, const void* kv_seg,
                           const void* seq_lens, int causal, int window) {
  return !(batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 ||
           q_len <= 0 || kv_len <= 0 ||
           (q_seg == nullptr) != (kv_seg == nullptr) || window < 0 ||
           (window > 0 && (!causal || seq_lens != nullptr)));
}

}  // namespace
