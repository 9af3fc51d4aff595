// Flash-attention-2 forward for Hopper (sm_90a) on mma.sync and the CUDA
// cores: the kernel bodies of the quantized instances (flash_fwd_quant.cu,
// int8/e4m3 K/V with per-token scales, bf16 or f32 q) and of the f32
// instances of flash_fwd.cu. The bf16 instances of flash_fwd.cu are the
// wgmma/TMA kernel of that source; the contract below is theirs too.
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
// payloads with per-token f32 scales (B, hkv, Skv), folded as the TPU kernels
// fold them (flash.py:268-273, :336-341): s *= kscale of its column before
// the mask, so a masked entry stays exactly the mask value; l sums the bare
// p; only the p packed for the PV product is multiplied by vscale of its
// column, in f32, before its one rounding. A tile's payload rows and scales
// ride the cp.async ring (16 elements per 16-byte copy, half the bytes of a
// bf16 row); once landed, the tile is converted in shared memory into a
// bf16 (f32 kernel: f32) tile of the unquantized layout, so both products
// read what they read without quantization. int8 converts exactly; e4m3 to
// bf16 repeats the TPU kernels' integer mapping (flash.py:59-80: the
// subnormal codes land high, the NaN codes give +/-480), e4m3 to f32 is
// exact (JAX's astype).
//
// What bounds it: at prefill shapes the tensor-core FLOPs (4 * rows * cols * D
// per head over the visible triangle), far above the card's
// operations-per-byte ridge. The quantized bf16 design: one block of 4 warps
// per (q tile of 64 rows, q head, batch); each warp owns 16 rows and runs
// mma.sync m16n8k16 (bf16 in, f32 accumulate) for S = Q K^T and O += P V with
// P kept in registers (the S accumulator layout is the A-operand layout).
// Payload tiles of 64 rows stream through a two-stage cp.async ring in
// shared memory. Causal blocks stop at the diagonal tile, and only tiles
// that straddle the diagonal or the ragged kv edge pay for the mask. The
// softmax state is online in f32 in the log2 domain: sm_scale * log2(e) is
// folded into q in the input dtype, as every TPU kernel does (flash.py:241).
// Blocks run longest causal rows first so the tail of the grid is short
// (pruned packed rows: longest pruned work first, from tile_order).
//
// The f32 kernel computes in real f32 FMAs on the CUDA cores (never TF32;
// the f32 gate is 2e-5): 256 threads, each owning a 4 x 4 piece of the
// 64 x 64 score tile and a 4 x D/16 piece of the output.
//
// Tile sizes come from tiny_flash_attention_tpu_torch/ops/configs.py as -D
// defines (FLASH_FWD_QUANT_BF16 for the quantized bf16 body, FLASH_FWD_F32
// for the f32 body, quantized or not); the build refuses to compile without
// them.

#pragma once

#include <type_traits>

#include "flash_common.cuh"

#if !defined(TFA_FWDQ_BF16_BLOCK_M) || !defined(TFA_FWDQ_BF16_BLOCK_N) ||  \
    !defined(TFA_FWDQ_BF16_THREADS) || !defined(TFA_FWD_F32_BLOCK_M) ||    \
    !defined(TFA_FWD_F32_BLOCK_N) || !defined(TFA_FWD_F32_THREADS)
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

// The per-token scales of quantized K/V, (B, hkv, kv_len) f32; null for kNone.
struct KvScales {
  const float* k;
  const float* v;
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

// One payload byte as bf16 bits: int8 exactly; e4m3 by the TPU kernels'
// mapping (flash.py:75-79) sign << 8 | ((mag << 4) + (120 << 7)), mag 0 a
// signed zero (exact for normal codes; subnormal codes land high, the NaN
// codes 0x7F/0xFF give +/-480).
template <int FMT>
__device__ __forceinline__ uint32_t payload_bf16_bits(uint32_t u) {
  if constexpr (FMT == kInt8) {
    const __nv_bfloat16 x =
        __float2bfloat16_rn((float)(int)(int8_t)(uint8_t)u);
    return (uint32_t)__bfloat16_as_ushort(x);
  } else {
    const uint32_t sign = (u & 0x80u) << 8, mag = u & 0x7Fu;
    return mag == 0 ? sign : sign | ((mag << 4) + (120u << 7));
  }
}

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

// A landed tile of `rows` payload rows of D bytes ([rows][D], contiguous) as
// bf16 rows of stride ld, 16 payload bytes a thread at a time.
template <int FMT, int D>
__device__ __forceinline__ void payload_tile_to_bf16(__nv_bfloat16* dst,
                                                     const uint8_t* src,
                                                     int rows, int ld,
                                                     int tid, int nthreads) {
  constexpr int PCH = D / 16;
  for (int c = tid; c < rows * PCH; c += nthreads) {
    const int r = c / PCH, col = (c % PCH) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * D + col);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t pair = w[i / 2] >> (16 * (i % 2));
      o[i] = payload_bf16_bits<FMT>(pair & 0xFFu) |
             (payload_bf16_bits<FMT>((pair >> 8) & 0xFFu) << 16);
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * ld + col);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
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

// ------------------------------------------------------ quantized bf16 path

constexpr int BM = TFA_FWDQ_BF16_BLOCK_M;
constexpr int BN = TFA_FWDQ_BF16_BLOCK_N;
constexpr int THREADS = TFA_FWDQ_BF16_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 8;  // bf16 per smem row: rows land 16 bytes apart in banks
static_assert(BM == WARPS * 16, "each warp owns 16 q rows");
static_assert(BN % 16 == 0, "kv tile is a multiple of the mma depth");
static_assert(BM == BN, "smem size assumes equal q and kv tiles");

// Dynamic shared memory of a quantized bf16 block: q and one converted K
// and V tile (rows padded), a two-stage ring of payload rows with their k
// and v scales, and the kv ids (ops/configs.py::fwd_smem_bytes mirrors it;
// tfa_flash_fwd_quant_smem exports it).
template <int D>
constexpr int bf16_quant_smem_bytes() {
  return 3 * BM * (D + PAD) * (int)sizeof(__nv_bfloat16) +
         2 * BN * (2 * D + 2 * (int)sizeof(float)) + 2 * BN * (int)sizeof(int);
}

template <int D, bool WINDOW, int FMT>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const KvElem<FMT, __nv_bfloat16>* __restrict__ k,
                          const KvElem<FMT, __nv_bfloat16>* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, FwdMasks mk, KvScales sc,
                          int hq, int hkv, int q_len, int kv_len, int causal,
                          float scale_log2, int window) {
  static_assert(FMT != kNone, "bf16 K/V take flash_fwd.cu's wgmma kernel");
  constexpr int LD = D + PAD;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BM * LD;  // [BN][LD], the converted K tile
  __nv_bfloat16* vs = ks + BN * LD;  // [BN][LD], the converted V tile
  // the ring of payload rows [2][BN][D] bytes and scales [2][BN]
  uint8_t* kp = reinterpret_cast<uint8_t*>(vs + BN * LD);
  uint8_t* vp = kp + 2 * BN * D;
  float* ksc = reinterpret_cast<float*>(vp + 2 * BN * D);
  float* vsc = ksc + 2 * BN;
  int* kid = reinterpret_cast<int*>(vsc + 2 * BN);  // [2][BN]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = mk.tile_order ? mk.tile_order[blockIdx.x]
                               : gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int offset = kv_len - q_len;
  const __nv_bfloat16* qg = q + (size_t)(b * hq + h) * q_len * D;
  const auto* kg = k + (size_t)(b * hkv + kvh) * kv_len * D;
  const auto* vg = v + (size_t)(b * hkv + kvh) * kv_len * D;
  __nv_bfloat16* og = o + (size_t)(b * hq + h) * q_len * D;
  float* lg = lse + (size_t)(b * hq + h) * q_len;
  const bool segs = mk.q_seg != nullptr;
  // jagged: columns end at L (the kv length otherwise), rows at L (q_len)
  const int col_end =
      mk.seq_lens ? min(max(mk.seq_lens[b], 0), kv_len) : kv_len;
  const int row_end = mk.seq_lens ? col_end : q_len;
  if (q0 >= row_end) {  // a jagged tile wholly past its row's length
    write_empty_rows<__nv_bfloat16, D>(og, lg, q0, min(BM, q_len - q0));
    return;
  }
  const int hi = min(kv_tiles(q0, BM, q_len, kv_len, causal, BN),
                     (col_end + BN - 1) / BN);
  int lo = mk.tile_lo ? max(0, min(mk.tile_lo[qt], hi - 1)) : 0;
  if (WINDOW) lo = window_lo(lo, hi, q0 + offset, window, BN);
  // every tile pays the mask with ids, and in a jagged tile that holds rows
  // past L
  const bool mask_all = segs || (mk.seq_lens && q0 + BM > row_end);
  const int* kv_ids = segs ? mk.kv_seg + (size_t)b * kv_len : nullptr;

  auto load_kv = [&](int tile, int buf) {
    const int kv0 = tile * BN;
    constexpr int PCH = D / 16;  // 16-byte chunks per payload row
    uint8_t* kd = kp + buf * BN * D;
    uint8_t* vd = vp + buf * BN * D;
    for (int c = tid; c < BN * PCH; c += THREADS) {
      const int r = c / PCH, col = (c % PCH) * 16;
      const bool valid = kv0 + r < kv_len;
      const size_t src = (size_t)(valid ? kv0 + r : 0) * D + col;
      cp_async16(kd + r * D + col, kg + src, valid);
      cp_async16(vd + r * D + col, vg + src, valid);
    }
    const size_t head = (size_t)(b * hkv + kvh) * kv_len;
    for (int r = tid; r < BN; r += THREADS) {
      const bool valid = kv0 + r < kv_len;
      const size_t src = head + (valid ? kv0 + r : 0);
      cp_async4(ksc + buf * BN + r, sc.k + src, valid);
      cp_async4(vsc + buf * BN + r, sc.v + src, valid);
    }
    if (segs) {
      for (int r = tid; r < BN; r += THREADS) {
        const bool valid = kv0 + r < kv_len;
        cp_async4(kid + buf * BN + r, kv_ids + (valid ? kv0 + r : 0), valid);
      }
    }
  };

  load_kv(lo, 0);
  cp_async_commit();

  // q tile, scaled by sm_scale*log2(e) rounded to bf16, product rounded to
  // bf16 (the TPU kernels' q = (q * c).astype(q.dtype)); rows past q_len = 0
  const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));
  for (int c = tid; c < BM * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < q_len)
      raw = *reinterpret_cast<const uint4*>(qg + (size_t)(q0 + r) * D + col);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * qscale);
    *reinterpret_cast<uint4*>(qs + r * LD + col) = raw;
  }
  __syncthreads();

  // A fragments of this warp's 16 q rows, kept in registers for every tile
  uint32_t qa[D / 16][4];
  {
    const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qa[kk], qs + row * LD + kk * 16 + (lane / 16) * 8);
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums, quad-reduced last
  // this thread's rows: qrow (accumulator slots 0,1) and qrow + 8 (slots 2,3)
  const int qrow = q0 + warp * 16 + lane / 4;
  const int warp_first_pos = q0 + warp * 16 + offset;
  // a tile whose first column lies left of the window edge of the warp's
  // last row pays the window compare
  const int warp_left = warp_first_pos + 15 - window + 1;
  int qid[2] = {0, 0};  // this thread's rows' segment ids
  if (segs) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qrow + r * 8;
      if (row < q_len) qid[r] = mk.q_seg[(size_t)b * q_len + row];
    }
  }

  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    // the landed payload tile into the bf16 staging tiles; the barrier at
    // the end of the previous iteration freed them
    payload_tile_to_bf16<FMT, D>(ks, kp + buf * BN * D, BN, LD, tid,
                                 THREADS);
    payload_tile_to_bf16<FMT, D>(vs, vp + buf * BN * D, BN, LD, tid,
                                 THREADS);
    __syncthreads();
    const __nv_bfloat16* kt = ks;
    const __nv_bfloat16* vt = vs;

    // S = Q K^T, 16 x BN per warp
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; nt += 2) {
        uint32_t bb[4];
        const int mi = lane / 8;
        ldsm_x4(bb, kt + (nt * 8 + (mi >> 1) * 8 + lane % 8) * LD + kk * 16 +
                        (mi & 1) * 8);
        mma_16816(s[nt], qa[kk], bb[0], bb[1]);
        mma_16816(s[nt + 1], qa[kk], bb[2], bb[3]);
      }
    }

    {
      // s *= kscale of its column, before the mask: a masked entry stays
      // exactly the mask value
      const float* kscale = ksc + buf * BN;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const float2 f = *reinterpret_cast<const float2*>(
            kscale + nt * 8 + (lane % 4) * 2);
        s[nt][0] *= f.x;
        s[nt][1] *= f.y;
        s[nt][2] *= f.x;
        s[nt][3] *= f.y;
      }
    }

    const int kv0 = j * BN;
    const bool need_mask = mask_all || kv0 + BN > col_end ||
                           (causal && kv0 + BN - 1 > warp_first_pos) ||
                           (WINDOW && kv0 < warp_left);
    if (need_mask) {
      const int* tile_ids = kid + buf * BN;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int c0 = nt * 8 + (lane % 4) * 2;
        const int2 kv_id = segs ? *reinterpret_cast<const int2*>(tile_ids + c0)
                                : make_int2(0, 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = kv0 + c0 + (i & 1);
          const int row = qrow + (i >> 1) * 8;
          const bool ok = col < col_end && row < row_end &&
                          (!causal || col <= row + offset) &&
                          (!WINDOW || col > row + offset - window) &&
                          (!segs || qid[i >> 1] == ((i & 1) ? kv_id.y : kv_id.x));
          if (!ok) s[nt][i] = kMaskValue;
        }
      }
    }

    // online softmax (log2 domain), one quad of lanes per row
    float m_new[2], keep[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_new[r] = mx;
      alpha[r] = exp2f(m_run[r] - mx);
      // fully-masked-row guard: a row that has seen only masked columns
      // keeps m at the mask floor, where exp2(s - m) would be 1
      keep[r] = mx > 0.5f * kMaskValue ? 1.f : 0.f;
      m_run[r] = mx;
    }

    uint32_t pa[BN / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_new[0]) * keep[0];
      const float p1 = exp2f(s[nt][1] - m_new[0]) * keep[0];
      const float p2 = exp2f(s[nt][2] - m_new[1]) * keep[1];
      const float p3 = exp2f(s[nt][3] - m_new[1]) * keep[1];
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      // p *= vscale of its column in f32, then the one rounding to bf16
      const float2 f = *reinterpret_cast<const float2*>(
          vsc + buf * BN + nt * 8 + (lane % 4) * 2);
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0 * f.x, p1 * f.y);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2 * f.x, p3 * f.y);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rs[r];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      oacc[dn][0] *= alpha[0];
      oacc[dn][1] *= alpha[0];
      oacc[dn][2] *= alpha[1];
      oacc[dn][3] *= alpha[1];
    }

    // O += P V (P in bf16, as the TPU kernels cast p before the second dot)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < D / 8; dn += 2) {
        uint32_t bb[4];
        const int mi = lane / 8;
        ldsm_x4_trans(bb, vt + (kk * 16 + (mi & 1) * 8 + lane % 8) * LD +
                              (dn + (mi >> 1)) * 8);
        mma_16816(oacc[dn], pa[kk], bb[0], bb[1]);
        mma_16816(oacc[dn + 1], pa[kk], bb[2], bb[3]);
      }
    }
    __syncthreads();  // the buffer is refilled two iterations from now
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_safe = (l == 0.f || l != l) ? 1.f : l;
    const int row = qrow + r * 8;
    if (row < q_len) {
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * D + col) =
            __floats2bfloat162_rn(oacc[dn][2 * r] / l_safe,
                                  oacc[dn][2 * r + 1] / l_safe);
      }
      if (lane % 4 == 0) lg[row] = m_run[r] * kLn2 + logf(l_safe);
    }
  }
}

template <int D, int FMT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, const FwdMasks& mk, const KvScales& sc,
                        int batch, int hq, int hkv, int q_len, int kv_len,
                        int causal, int window, float scale_log2,
                        cudaStream_t stream) {
  const int smem = bf16_quant_smem_bytes<D>();
  using KV = KvElem<FMT, __nv_bfloat16>;
  const bool windowed = window > 0;
  const auto kernel = windowed ? flash_fwd_bf16_kernel<D, true, FMT>
                               : flash_fwd_bf16_kernel<D, false, FMT>;
  static bool smem_set[2][kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(kernel, smem, smem_set[windowed]);
  if (err != cudaSuccess) return err;
  const dim3 grid((q_len + BM - 1) / BM, hq, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), mk, sc, hq, hkv, q_len, kv_len, causal,
      scale_log2, window);
  return cudaGetLastError();
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
      const size_t head = (size_t)(b * hkv + kvh) * kv_len;
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

// One launch of the quantized instance for q's dtype (0 bf16, 1 f32) and
// head_dim (64 or 128) over K/V of payload format FMT;
// cudaErrorInvalidValue for any other. The caller has checked the rest.
template <int FMT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, const FwdMasks& mk, const KvScales& sc,
                       int batch, int hq, int hkv, int q_len, int kv_len,
                       int head_dim, int causal, int window, float scale_log2,
                       int dtype, cudaStream_t s) {
  if (dtype == 0 && head_dim == 128)
    return launch_bf16<128, FMT>(q, k, v, o, lse, mk, sc, batch, hq, hkv,
                                 q_len, kv_len, causal, window, scale_log2, s);
  if (dtype == 0 && head_dim == 64)
    return launch_bf16<64, FMT>(q, k, v, o, lse, mk, sc, batch, hq, hkv,
                                q_len, kv_len, causal, window, scale_log2, s);
  if (dtype == 1 && head_dim == 128)
    return launch_f32<128, FMT>(q, k, v, o, lse, mk, sc, batch, hq, hkv,
                                q_len, kv_len, causal, window, scale_log2, s);
  if (dtype == 1 && head_dim == 64)
    return launch_f32<64, FMT>(q, k, v, o, lse, mk, sc, batch, hq, hkv,
                               q_len, kv_len, causal, window, scale_log2, s);
  return cudaErrorInvalidValue;
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
