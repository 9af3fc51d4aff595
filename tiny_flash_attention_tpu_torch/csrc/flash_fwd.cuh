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
// The f32 kernel (f32 q, below) computes in real f32 FMAs on the CUDA
// cores (never TF32; the f32 gate is 2e-5) over a host-built work list of
// kv runs, longest first, merged in a fixed order; its tile_lo, tile_order
// and window arrive folded into that list, not as FwdMasks.
//
// Tile sizes come from tiny_flash_attention_tpu_torch/ops/configs.py as -D
// defines (FLASH_FWD_F32); the build refuses to compile without them.

#pragma once

#include <type_traits>

#include "f32_tiles.cuh"

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

// Rows [q0, q0 + rows) of width w as empty rows: out 0, LSE the sentinel m
// * ln2 of a row whose running max stayed at the mask value. Zero is
// all-zero bits in bf16 and f32, and the rows are whole 16-byte stores (w a
// multiple of 8 in bf16, and q0 a multiple of 8).
template <typename T>
__device__ void write_empty_rows(T* og, float* lg, int q0, int rows, int w) {
  uint4* dst = reinterpret_cast<uint4*>(og + (size_t)q0 * w);
  const int n = rows * w * (int)sizeof(T) / 16;
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
//
// f32 q over f32 K/V, or over int8/e4m3 payloads converted to f32 exactly:
// real f32 FMAs on the CUDA cores, never TF32 (the f32 gate is 2e-5). What
// bounds it: the FMAs, 2 * D a visible (row, column) pair and q head at
// 67 TF/s. The design:
//   * runs: each 128-row q tile's kv range [lo, hi) (the causal clamp,
//     tile_lo's pruning and the window's band, built on the host:
//     ops/flash.py::fwd_f32_work) is cut at the multiples of
//     FLASH_FWD_F32_SPLIT kv tiles into runs, one block per (run, q head,
//     batch), the longest runs first. Under the causal mask one block per q
//     tile gives tiles of very unequal length (at the f32 train step's
//     (1, 8, 1024), 128 blocks of 64-row tiles walking 1 to 16 kv tiles,
//     one wave on 132 SMs); the runs fill the card more evenly.
//   * a run whose tile has more runs writes its partial (o unnormalized, m
//     in the log2 domain, l) to a slot of its own (the work list's slot
//     index; tiles of one run have none); the last run of the tile
//     to arrive (a counter per (q tile, q head, batch), which it sets back
//     to 0) combines the tile's runs in run order with the exact LSE
//     combine, its own from its registers; a tile of one run writes its
//     rows directly by the same formula. So two calls give the same bits,
//     and segment_starts' pruning changes no bit: the cuts sit at fixed
//     tiles, and a run it drops holds only masked tiles, whose partial adds
//     exact zeros.
//   * 256 threads over a 128 x 64 score tile: thread (a, g) = (tid / 16,
//     tid % 16) holds S at rows 8a .. 8a + 7 and columns g + 16 i (8 x 4,
//     f32_tiles.cuh's score_tile: 12 float4 reads for 128 FMAs) and O at
//     the same 8 rows (8 x D / 16, accumulate: 4 float4 reads for 64 FMAs at
//     head_dim 128), so a row's max and sum reduce over 16 lanes and its
//     rescale stays in the thread. P goes to shared memory transposed
//     (P^T, kv x q), swizzled.
//   * head_dim 256 (the wide instance, F32Tiles<256>): q tiles of 64 rows
//     and kv tiles of 32, the same threads over a 64 x 32 score tile, S at
//     4 rows x 2 columns and O at 4 rows x 16 columns a thread (64
//     registers, as at 128): a 128-row q tile alone would be 128 KiB and
//     two 64-row K/V stages 256 KiB, over the block's 227 KB.
//   * K and V stream through a two-stage ring: tile t + 1's copies
//     (cp.async) are issued as tile t's products start and waited for at
//     the top of step t + 1, two barriers a step. Quantized, tile t + 1's
//     payload bytes are loaded into registers as step t starts and
//     converted into the free stage after its PV product; the ids and
//     scales ride the ring by cp.async.
//   * shared memory (F32Layout): q (scaled by scale_log2 in place once it
//     lands), two K/V stages, P^T, and each stage's ids (quantized, its k
//     and v scales): 229,888 bytes at head_dim 128 (230,912 quantized),
//     205,056 at 256, one block an SM.

#if !defined(TFA_FWD_F32_WIDE_BLOCK_M) || !defined(TFA_FWD_F32_WIDE_BLOCK_N) || \
    !defined(TFA_FWD_F32_WIDE_THREADS)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

constexpr int FTHREADS = TFA_FWD_F32_THREADS;
static_assert(FTHREADS == 256 && TFA_FWD_F32_WIDE_THREADS == FTHREADS,
              "the f32 thread map is 16 x 16 threads");

// The f32 tiles at head_dim D: FM q rows and FN kv rows (FLASH_FWD_F32, or
// FLASH_FWD_F32_WIDE above 128); thread t owns rows RW (t / 16) + [0, RW)
// and columns t % 16 + 16 * [0, CW).
template <int D>
struct F32Tiles {
  static constexpr bool WIDE = D > 128;
  static constexpr int FM =
      WIDE ? TFA_FWD_F32_WIDE_BLOCK_M : TFA_FWD_F32_BLOCK_M;
  static constexpr int FN =
      WIDE ? TFA_FWD_F32_WIDE_BLOCK_N : TFA_FWD_F32_BLOCK_N;
  static constexpr int RW = FM / 16, CW = FN / 16;
  static_assert(WIDE ? FM == 64 && FN == 32 : FM == 128 && FN == 64,
                "16 x 16 threads over a 128 x 64 (or, wide, 64 x 32) tile");
};

// The f32 body's shared memory, in floats: q [FM][D], two stages of K and
// V [FN][D], P^T [FN][FM], and each stage's rows [ROWS][FN] (kv ids;
// quantized, also the k and v scales).
template <int D, int FMT>
struct F32Layout {
  static constexpr int FM = F32Tiles<D>::FM, FN = F32Tiles<D>::FN;
  static constexpr int ROWS = FMT == kNone ? 1 : 3;
  static constexpr int Q = 0;
  static constexpr int KV = FM * D;
  static constexpr int PT = KV + 4 * FN * D;
  static constexpr int ROWS_AT = PT + FN * FM;
  static constexpr int BYTES = (ROWS_AT + 2 * ROWS * FN) * 4;
  // and one static int: the merge's arrival flag
  static_assert(BYTES + 4 <= 232448, "a block has 227 KB of shared memory");
};

// Dynamic shared memory of an f32 block (ops/configs.py::fwd_smem_bytes
// mirrors it; tfa_flash_fwd_smem and tfa_flash_fwd_quant_smem export it).
template <int D, int FMT>
constexpr int f32_smem_bytes() {
  return F32Layout<D, FMT>::BYTES;
}

// The f32 launch's work list (ops/flash.py::fwd_f32_work: n_items runs
// over the q tiles of FM rows, F32Tiles<D>, then each item's slot,
// fwd_f32_slots) and its merge workspace: partials, a slot x batch x hq
// array of FM x (D + 2) f32 (o, then m, then l), for the items of tiles of
// more than one run; arrivals, one zeroed int per (batch, q head, q tile),
// left at 0. Both may be null where every tile is one run.
struct F32Runs {
  const int* work;
  int n_items;
  float* partials;
  int* arrivals;
};

template <int D, bool WINDOW, int FMT>
__global__ void __launch_bounds__(FTHREADS, 1)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const KvElem<FMT, float>* __restrict__ k,
                         const KvElem<FMT, float>* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ lse,
                         FwdMasks mk, KvScales sc, F32Runs runs, int batch,
                         int hq, int hkv, int q_len, int kv_len, int causal,
                         float scale_log2, int window) {
  constexpr bool QUANT = FMT != kNone;
  constexpr int C4 = D / 4, C16 = D / 16;        // 16-byte chunks a row
  constexpr int FM = F32Tiles<D>::FM, FN = F32Tiles<D>::FN;
  constexpr int RW = F32Tiles<D>::RW, CW = F32Tiles<D>::CW;
  using L = F32Layout<D, FMT>;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm + L::Q;
  float* pt = fsm + L::PT;
  auto kst = [&](int st) { return fsm + L::KV + st * 2 * FN * D; };
  auto vst = [&](int st) { return fsm + L::KV + (st * 2 + 1) * FN * D; };
  auto rows = [&](int st) { return fsm + L::ROWS_AT + st * L::ROWS * FN; };

  const Work wk(runs.work, runs.n_items);
  const int n_bh = batch * hq;
  const int item = wk.order[blockIdx.x / n_bh];
  const int bh = blockIdx.x % n_bh;
  const int h = bh % hq, b = bh / hq;
  const int kvh = h / (hq / hkv);
  const int tile = wk.tile[item], q0 = tile * FM;
  const int first = wk.first[tile], n_runs = wk.first[tile + 1] - first;
  const int tid = threadIdx.x, a = tid / 16, g = tid % 16;
  const int offset = kv_len - q_len;
  const float* qg = q + (size_t)bh * q_len * D;
  const auto* kg = k + (size_t)(b * hkv + kvh) * kv_len * D;
  const auto* vg = v + (size_t)(b * hkv + kvh) * kv_len * D;
  const bool segs = mk.q_seg != nullptr;
  const int col_end =
      mk.seq_lens ? min(max(mk.seq_lens[b], 0), kv_len) : kv_len;
  const int row_end = mk.seq_lens ? col_end : q_len;
  // the run's kv tiles, clamped to the jagged length (a q tile at or past
  // it visits none: its rows are empty)
  const int lo = wk.lo[item];
  const int hi = q0 >= row_end ? lo
                               : min(wk.hi[item], (col_end + FN - 1) / FN);
  const int n = max(0, hi - lo);
  const bool mask_all = segs || (mk.seq_lens && q0 + FM > row_end);
  const int* kv_ids = segs ? mk.kv_seg + (size_t)b * kv_len : nullptr;
  const size_t scale_head = (size_t)(b * hkv + kvh) * sc.ld;
  int qid[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) qid[i] = 0;
  if (segs) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = q0 + RW * a + i;
      if (row < q_len) qid[i] = mk.q_seg[(size_t)b * q_len + row];
    }
  }

  // tile `it` of the run into stage it % 2 by cp.async: f32 K and V, the
  // kv ids, quantized the k and v scales (the payloads go by registers)
  auto stage_kv = [&](int it) {
    const int kv0 = (lo + it) * FN;
    float* rw = rows(it & 1);
    if constexpr (!QUANT) {
      stage_tile<D, FN, FTHREADS>(kst(it & 1), kg, kv0, kv_len, tid);
      stage_tile<D, FN, FTHREADS>(vst(it & 1), vg, kv0, kv_len, tid);
    } else {
      if (tid >= FN && tid < 2 * FN)
        stage_row(rw + FN, sc.k + scale_head, kv0, kv_len, tid - FN);
      else if (tid >= 2 * FN && tid < 3 * FN)
        stage_row(rw + 2 * FN, sc.v + scale_head, kv0, kv_len, tid - 2 * FN);
    }
    if (segs && tid < FN) stage_row(rw, kv_ids, kv0, kv_len, tid);
  };
  // quantized: tile `it`'s K and V payload rows into registers (rows past
  // kv_len as zeros), 16 bytes at a time; then, converted to f32, into a
  // stage
  constexpr int PW = QUANT ? FN * C16 / FTHREADS : 1;
  static_assert(!QUANT || FN * C16 % FTHREADS == 0, "whole payload chunks");
  uint4 pk[PW], pv[PW];
  auto load_payload = [&](int it) {
    if constexpr (QUANT) {
      const int kv0 = (lo + it) * FN;
#pragma unroll
      for (int w = 0; w < PW; ++w) {
        const int x = tid + w * FTHREADS, r = x / C16, c = (x % C16) * 16;
        const bool ok = kv0 + r < kv_len;
        const size_t at = (size_t)(ok ? kv0 + r : 0) * D + c;
        pk[w] = ok ? *reinterpret_cast<const uint4*>(kg + at)
                   : make_uint4(0u, 0u, 0u, 0u);
        pv[w] = ok ? *reinterpret_cast<const uint4*>(vg + at)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto store_payload = [&](int st) {
    if constexpr (QUANT) {
#pragma unroll
      for (int w = 0; w < PW; ++w) {
        const int x = tid + w * FTHREADS, r = x / C16, c = (x % C16) * 16;
        const uint32_t kw[4] = {pk[w].x, pk[w].y, pk[w].z, pk[w].w};
        const uint32_t vw[4] = {pv[w].x, pv[w].y, pv[w].z, pv[w].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<float4*>(kst(st) + sw<D>(r, c + 4 * j)) =
              payload4_f32<FMT>(kw[j]);
          *reinterpret_cast<float4*>(vst(st) + sw<D>(r, c + 4 * j)) =
              payload4_f32<FMT>(vw[j]);
        }
      }
    }
  };

  stage_tile<D, FM, FTHREADS>(qs, qg, q0, q_len, tid);
  if (n > 0) stage_kv(0);
  cp_async_commit();
  if (n > 0) {       // quantized: the first tile's payloads at once
    load_payload(0);
    store_payload(0);
  }

  float acc[RW][D / 16];
  float m_run[RW], l_run[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int it = 0; it < n; ++it) {
    const int st = it & 1, kv0 = (lo + it) * FN;
    cp_async_wait<0>();
    if (it == 0) {   // the fold, on the q chunks this thread copied
      for (int x = tid; x < FM * C4; x += FTHREADS) {
        float4* p = reinterpret_cast<float4*>(qs + sw<D>(x / C4, x % C4 * 4));
        float4 y = *p;
        y.x *= scale_log2; y.y *= scale_log2;
        y.z *= scale_log2; y.w *= scale_log2;
        *p = y;
      }
    }
    __syncthreads();   // tile it and q landed for all; P^T and the other
                       // stage are no longer read
    if (it + 1 < n) {  // tile it + 1 lands while this step runs
      stage_kv(it + 1);
      cp_async_commit();
      load_payload(it + 1);
    }
    const float* rw = rows(st);

    float s[RW][CW];
    score_tile<D, RW, CW, false, false>(s, qs, kst(st), 1.f, a, g);
    if constexpr (QUANT) {  // s *= kscale of its column, before the mask
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float f = rw[FN + g + 16 * j];
#pragma unroll
        for (int i = 0; i < RW; ++i) s[i][j] *= f;
      }
    }
    if (mask_all || kv0 + FN > col_end ||
        (causal && kv0 + FN - 1 > q0 + offset) ||
        (WINDOW && kv0 < q0 + FM + offset - window)) {
      const int* kid = reinterpret_cast<const int*>(rw);
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const int col = kv0 + g + 16 * j, row = q0 + RW * a + i;
          const bool ok = col < col_end && row < row_end &&
                          (!causal || col <= row + offset) &&
                          (!WINDOW || col > row + offset - window) &&
                          (!segs || qid[i] == kid[g + 16 * j]);
          if (!ok) s[i][j] = kMaskValue;
        }
    }

#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int j = 0; j < CW; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float alpha = exp2f(m_run[i] - mx);
      const float keep = mx > 0.5f * kMaskValue ? 1.f : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float p = exp2f(s[i][j] - mx) * keep;
        rs += p;
        // quantized: l sums the bare p, PV takes p * vscale of its column
        s[i][j] = QUANT ? p * rw[2 * FN + g + 16 * j] : p;
      }
      l_run[i] = alpha * l_run[i] + rs;
      m_run[i] = mx;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < CW; ++j)
#pragma unroll
      for (int h = 0; h < RW / 4; ++h)
        *reinterpret_cast<float4*>(pt + sw<FM>(g + 16 * j, RW * a + 4 * h)) =
            make_float4(s[4 * h][j], s[4 * h + 1][j], s[4 * h + 2][j],
                        s[4 * h + 3][j]);
    __syncthreads();   // P^T written
    accumulate<D, RW, FM, FN>(acc, pt, vst(st), a, g);
    if (it + 1 < n) store_payload((it + 1) & 1);
  }
  cp_async_wait<0>();  // a run of no tiles: q still in flight

#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int w = 1; w < 16; w <<= 1)
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], w);

  // a tile of several runs: the partial into this run's slot (a tile's
  // items have consecutive slots, from its first item's); the last run to
  // arrive goes on to combine them all
  const int slot0 = n_runs > 1 ? wk.first[(q_len + FM - 1) / FM + 1 + first]
                               : 0;
  auto slot = [&](int x) {
    return runs.partials +
           ((size_t)(slot0 + x - first) * n_bh + bh) * FM * (D + 2);
  };
  if (n_runs > 1) {
    float* part = slot(item);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = RW * a + i;
#pragma unroll
      for (int cc = 0; cc < D / 64; ++cc)
        *reinterpret_cast<float4*>(part + r * D + 4 * (g + 16 * cc)) =
            make_float4(acc[i][4 * cc], acc[i][4 * cc + 1],
                        acc[i][4 * cc + 2], acc[i][4 * cc + 3]);
      if (g == 0) {
        part[FM * D + r] = m_run[i];
        part[FM * D + FM + r] = l_run[i];
      }
    }
    __shared__ int last;
    __threadfence();
    __syncthreads();
    int* count = runs.arrivals + (size_t)bh * ((q_len + FM - 1) / FM) + tile;
    if (tid == 0) last = atomicAdd(count, 1) == n_runs - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (tid == 0) *count = 0;  // ready for the next call
  }

  // the tile's runs in run order, this block's own from its registers:
  // o = sum w_x o_x / sum w_x l_x, w_x = 2^(m_x - max m); an empty row
  // (no visible column in any run) gets 0 and the sentinel m * ln2
  float* og = o + (size_t)bh * q_len * D;
  float* lg = lse + (size_t)bh * q_len;
  const int own = item - first;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = RW * a + i;
    float mx = m_run[i];
    for (int x = 0; x < n_runs; ++x)
      if (x != own) mx = fmaxf(mx, __ldcg(slot(first + x) + FM * D + r));
    float den = 0.f, num[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) num[c] = 0.f;
    for (int x = 0; x < n_runs; ++x) {
      float m_x = m_run[i], l_x = l_run[i], o_x[D / 16];
      if (x == own) {
#pragma unroll
        for (int c = 0; c < D / 16; ++c) o_x[c] = acc[i][c];
      } else {
        const float* part = slot(first + x);
        m_x = __ldcg(part + FM * D + r);
        l_x = __ldcg(part + FM * D + FM + r);
#pragma unroll
        for (int cc = 0; cc < D / 64; ++cc) {
          const float4 y = __ldcg(reinterpret_cast<const float4*>(
              part + r * D + 4 * (g + 16 * cc)));
          o_x[4 * cc] = y.x; o_x[4 * cc + 1] = y.y;
          o_x[4 * cc + 2] = y.z; o_x[4 * cc + 3] = y.w;
        }
      }
      const float w = m_x == -INFINITY ? 0.f : exp2f(m_x - mx);
      den += l_x * w;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) num[c] += o_x[c] * w;
    }
    const int row = q0 + r;
    if (row < q_len) {
      const float l_safe = (den == 0.f || den != den) ? 1.f : den;
#pragma unroll
      for (int cc = 0; cc < D / 64; ++cc)
        *reinterpret_cast<float4*>(og + (size_t)row * D + 4 * (g + 16 * cc)) =
            make_float4(num[4 * cc] / l_safe, num[4 * cc + 1] / l_safe,
                        num[4 * cc + 2] / l_safe, num[4 * cc + 3] / l_safe);
      if (g == 0) lg[row] = fmaxf(mx, kMaskValue) * kLn2 + logf(l_safe);
    }
  }
}

template <int D, int FMT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, const FwdMasks& mk, const KvScales& sc,
                       const F32Runs& runs, int batch, int hq, int hkv,
                       int q_len, int kv_len, int causal, int window,
                       float scale_log2, cudaStream_t stream) {
  constexpr int FM = F32Tiles<D>::FM;
  const long blocks = (long)runs.n_items * batch * hq;
  if (runs.work == nullptr || runs.n_items < (q_len + FM - 1) / FM ||
      blocks > 0x7FFFFFFFL)
    return cudaErrorInvalidValue;
  const int smem = f32_smem_bytes<D, FMT>();
  using KV = KvElem<FMT, float>;
  const bool windowed = window > 0;
  const auto kernel = windowed ? flash_fwd_f32_kernel<D, true, FMT>
                               : flash_fwd_f32_kernel<D, false, FMT>;
  static bool smem_set[2][kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(kernel, smem, smem_set[windowed]);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, FTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), mk, sc, runs, batch, hq, hkv, q_len, kv_len,
      causal, scale_log2, window);
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
