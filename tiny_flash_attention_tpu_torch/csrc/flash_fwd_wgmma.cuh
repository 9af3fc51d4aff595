// The Hopper (sm_90a) flash-attention-2 forward on wgmma and TMA, for bf16 q:
// one kernel body that flash_fwd.cu instantiates over bf16 K/V and
// flash_fwd_quant.cu over int8 or e4m3 K/V payloads with per-token f32
// scales. The contract and every mask (segment ids, tile_lo and tile_order
// from segment_starts, the window, the jagged seq_lens mode, the mask value
// and the empty-row sentinel) are those of flash_fwd.cuh.
//
// What bounds it: the tensor-core FLOPs (4 * d per visible (row, column)
// pair and q head), far above the card's operations-per-byte ridge at
// prefill shapes. The design, FA3's structure (without its persistent tile
// scheduler):
//   * one block of three warpgroups per (q tile of 128 rows, q head, batch):
//     warpgroups 0 and 1 consume, 64 q rows each; warpgroup 2 produces. The
//     producer gives registers back (setmaxnreg) and the consumers take them:
//     S and O are 64 f32 a thread each at head_dim 128, P 32 packed bf16
//     pairs.
//   * one elected producer thread loads the q tile once by TMA. bf16 K/V:
//     the same thread streams 128-row K and V tiles through a ring of STAGES
//     stages by TMA: 3-D tensor maps over (d, rows, batch * heads) in the
//     128-byte swizzle, tiles of D = 128 columns as two 64-column boxes,
//     rows past a head's length filled with zeros (the mask covers them).
//     Each stage has a full barrier for K and its kv ids, one for V (so S
//     starts before V has landed), and an empty barrier on which the 256
//     consumer threads arrive once they have read it. The kv ids come by
//     bulk copy where kv_len and the pointer keep the source 16-byte
//     aligned, else by the producer warp's own loads.
//   * q, K, V and out are read and written at their true head_dim d (any
//     multiple of 8 up to the tiles' D; hopper.cuh::flash_width picks the
//     instance): the maps' boxes land zeros past column d, and those zero
//     columns add exact zeros to every product, so the result is the bits
//     of the same call on tensors padded to D. An instance of width N (64,
//     80, 96, 128 or 256) runs its products over N columns only: S over N / 16
//     k-steps, PV as m64nNk16 (a 48-float O at N = 96), so at d = 96 a
//     third of the padded products is not issued (each output column
//     accumulates alone, and a skipped k-step would add exact zeros). The
//     epilogue stores the columns below d at stride d: no pad or slice
//     copy.
//   * quantized K/V (FMT kInt8 or kE4m3): the producer warpgroup fills the
//     same ring in the same layout, so the consumers see a stage exactly as
//     they do over bf16 K/V. Its elected thread bulk-copies a tile's K and V
//     payload rows (half a bf16 tile's bytes) into the second half of their
//     stage as soon as the stage is free, one tile ahead, on a pay_full
//     barrier of the stage. Then the 128 producer threads expand each tile
//     in place: they convert two payload bytes per instruction on packed
//     32-bit words (int8: a byte permute, two lop3 and one bf16x2 fma
//     against a magic number, exactly; e4m3: the TPU kernels' integer
//     mapping, flash.py:59-80, with shifts, a byte permute that spreads a
//     nonzero flag and lop3) and store the bf16 rows in the 128-byte
//     swizzle, first the half of the tile that the payload does not
//     occupy (the other half's payload read into registers meanwhile),
//     then, after a barrier among them, the other half. Each thread fences
//     the async proxy and arrives on the stage's full barrier, whose count
//     is all 128. A quarter warp takes two neighbouring rows, four 16-byte
//     chunks of each, so its payload reads and its swizzled stores both hit
//     eight different bank groups. A payload ring beside three bf16 stages
//     does not fit (232,016 of the block's 232,448 bytes at head_dim 128),
//     and a first design that loaded the payload rows into the producer's
//     registers held too few bytes in flight (16 KB an SM): so the payload
//     lands in the stage it expands into, and the ring keeps its three
//     stages. The per-token scales are read by the consumers through L1
//     (pairs of columns, prefetched by the producer when it copies the
//     tile): the k scales of a tile before its mask, the v scales where P
//     is packed. Their softmax takes the fully-masked-row guard as the
//     subtrahend (exp2(s - inf) = 0), not a product, which saves back one
//     of the two scale products.
//   * a consumer folds bf16(sm_scale * log2 e) into its 64 rows of q in
//     shared memory (generic stores, then the async-proxy fence and a
//     warpgroup barrier before wgmma reads them), then for each kv tile: S =
//     Q K^T as SS wgmma m64n128k16 over N / 16 steps; quantized, s times the
//     k scale of its column; the element mask, paid only by warps whose tile
//     straddles the diagonal, the window's left edge or the kv edge, or has
//     ids; the online softmax in f32 in the log2 domain (the accumulator
//     holds rows lane / 4 and + 8 of each warp's 16 at columns 2 * (lane %
//     4) of every 8, as mma.sync does, so each row's max and sum reduce over
//     a quad; exp2 on the special-function unit with subnormal results
//     flushed, as in the backward; l sums the bare p); P rounded to bf16
//     (quantized: p times the v scale of its column in f32 first, the one
//     rounding after) is, packed, the A operand of the RS wgmma O += P V (V
//     read MN-major, m64n{N}k16 over 8 steps); then the stage is released.
//     Tile j's S product is issued before tile j - 1's PV product, so the
//     softmax of tile j runs while the tensor cores do that PV product
//     (FA3's intra-warpgroup overlap), and O is rescaled once it has landed.
//     So a consumer holds two stages at a time, and the ring has three.
//   * the two consumers take turns to issue their products (FA3's
//     ping-pong, two named barriers), so one's softmax runs while the
//     tensor cores do the other's products.
//   * the wide instance (N = 256: head dims in (128, 256], tiles of four
//     64-column boxes) keeps this structure over 64-row kv tiles and a ring
//     of two stages (ops/configs.py FLASH_FWD_BF16_WIDE): the q tile alone
//     is 64 KiB and one 128-row K+V stage 128 KiB, so 128-row tiles fit one
//     stage at most, and three 64-row stages do not fit (256 KiB). A
//     consumer's O is 128 f32 registers, S 32, P 16 packed pairs; PV is
//     m64n256k16. With two stages the overlap above would hold both: the
//     stage's empty barrier is split into K's and V's (k_empty, empty), the
//     consumers release tile j's K once its softmax has read its scores
//     and ids, and V once its PV product has landed, so the producer loads
//     tile j + 2's K while tile j + 1's S runs. Its quantized instances
//     (head dims in (128, 256] padded to 256 by the wrapper) keep both: a
//     64-row payload tile is 16 KiB and lands in blocks 2-3 of its 32 KiB
//     slot, so the producer expands blocks 0-1 first, holding the chunks
//     that 2-3 will take in registers (64 bytes a thread), then, after its
//     barrier, 2-3; K's and V's payloads land on barriers of their own
//     (pay_full, v_pay) once k_empty and empty free their slots, and the
//     producer expands tile j + 1's K and tile j's V while the consumers
//     run tile j's S and tile j - 1's PV.
//   * the instance of width 512 (head dims in (256, 512], tiles of eight
//     64-column boxes; ops/configs.py FLASH_FWD_BF16_512): O over 512
//     columns would be 256 f32 registers a consumer thread, so the block's
//     two consumers take the same 64 q rows (HALVES) and split O's columns,
//     each holding 128 floats of its 256-column half and issuing PV as
//     m64n256k16 over its half of the V tile. Both compute the whole S = Q
//     K^T (m64n32k16 over 32 k-steps) from the same tiles in the same
//     order, so their scores, softmax and row statistics are the same bits,
//     and only the first writes the LSE. Each folds the q scale into its
//     half of the q tile's boxes, then both wait on one barrier. Shared
//     memory: a 64-row q tile (64 KiB) and 32-row K and V tiles (32 KiB
//     each) in a two-stage ring whose K and V slots are released apart, as
//     at 256 (197,960 bytes; 64-row kv tiles would take 192 KiB in one
//     stage). A 512-column row is eight TMA boxes of 64 columns (the
//     128-byte swizzle's inner box), each landing zeros past column d. The
//     ping-pong and the intra-warpgroup overlap are kept. Not quantized.
// Blocks run longest causal rows first (tile_order's longest pruned work
// first with segment_starts). A warpgroup whose rows all lie past q_len or
// the jagged length only keeps the ring's count and writes empty rows.
//
// Tile sizes and stages come from tiny_flash_attention_tpu_torch/ops/
// configs.py (FLASH_FWD_BF16, FLASH_FWD_BF16_STAGES) as -D defines; the
// shared-memory layout is FwdSmem (tfa_flash_fwd_smem and
// tfa_flash_fwd_quant_smem export its size).

#pragma once

#include "flash_fwd.cuh"
#include "hopper.cuh"

#if !defined(TFA_FWD_BF16_BLOCK_M) || !defined(TFA_FWD_BF16_BLOCK_N) || \
    !defined(TFA_FWD_BF16_THREADS) || !defined(TFA_FWD_BF16_STAGES) ||    \
    !defined(TFA_FWD_BF16_WIDE_BLOCK_M) ||                                \
    !defined(TFA_FWD_BF16_WIDE_BLOCK_N) ||                                \
    !defined(TFA_FWD_BF16_WIDE_THREADS) ||                                \
    !defined(TFA_FWD_BF16_WIDE_STAGES) ||                                 \
    !defined(TFA_FWD_BF16_512_BLOCK_M) ||                                 \
    !defined(TFA_FWD_BF16_512_BLOCK_N) ||                                 \
    !defined(TFA_FWD_BF16_512_THREADS) || !defined(TFA_FWD_BF16_512_STAGES)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

constexpr int WM = TFA_FWD_BF16_BLOCK_M;        // q rows per block
constexpr int WTHREADS = TFA_FWD_BF16_THREADS;  // 2 consumers + 1 producer
static_assert(WM == 128 && TFA_FWD_BF16_BLOCK_N == 128 && WTHREADS == 384 &&
                  TFA_FWD_BF16_WIDE_BLOCK_M == WM &&
                  TFA_FWD_BF16_WIDE_BLOCK_N == 64 &&
                  TFA_FWD_BF16_WIDE_THREADS == WTHREADS &&
                  TFA_FWD_BF16_WIDE_STAGES == 2 &&
                  TFA_FWD_BF16_512_BLOCK_M == 64 &&
                  TFA_FWD_BF16_512_BLOCK_N == 32 &&
                  TFA_FWD_BF16_512_THREADS == WTHREADS &&
                  TFA_FWD_BF16_512_STAGES == 2,
              "two consumer warpgroups of 64 q rows and a producer "
              "warpgroup over 128-row kv tiles (64-row in two stages at "
              "the wide instance; at 512 both consumers on the same 64 q "
              "rows over 32-row kv tiles in two stages)");

// The q tile, the kv tile and the ring of the instances over tiles of D
// columns: 128 q rows (64 a consumer) and 128-row kv tiles in
// TFA_FWD_BF16_STAGES stages up to 128 columns, 64-row kv tiles in two
// stages at 256, whose K and V slots are released apart (SPLIT); at 512
// (HALVES) 64 q rows that both consumers take, each the products of one
// 256-column half of O, over 32-row kv tiles in two split stages.
template <int D>
struct FwdTiles {
  static constexpr bool WIDE = D > 128;
  static constexpr bool HALVES = D > 256;
  static constexpr int BM = HALVES ? TFA_FWD_BF16_512_BLOCK_M : WM;
  static constexpr int BN =
      HALVES ? TFA_FWD_BF16_512_BLOCK_N
             : WIDE ? TFA_FWD_BF16_WIDE_BLOCK_N : TFA_FWD_BF16_BLOCK_N;
  static constexpr int STAGES =
      HALVES ? TFA_FWD_BF16_512_STAGES
             : WIDE ? TFA_FWD_BF16_WIDE_STAGES : TFA_FWD_BF16_STAGES;
  static constexpr bool SPLIT = STAGES == 2;
};

constexpr int CONSUMERS = 256;  // consumer threads: arrivals on an empty slot
constexpr int PRODUCERS = 128;  // quantized: arrivals on a full slot
// Registers a thread by role, of the launch's 168 * 384 = 64512: bf16 K/V,
// 40 for the producer (an elected TMA thread) and 232 for the consumers;
// quantized K/V, 88 for the producer, which expands the payloads (at fewer
// it spills more and runs slower, PERF.md), and the rest, 208, for the
// consumers. At the wide instance (tiles of D = 256 columns) the quantized
// producer holds what it does at 128 (its half of a tile's payload chunks,
// 16 registers) and the consumers 128 O floats, 32 S floats and 16 P
// registers, so the producer keeps 56 and the consumers take 224 (ptxas
// spills less from the consumers there than at 216 or 208; chip_smoke.py's
// build line prints each instance's spill bytes).
constexpr int WIDE_QUANT_PRODUCER_REGS = 56;
template <int FMT, int D>
constexpr int kProducerRegs =
    FMT == kNone ? 40 : D > 128 ? WIDE_QUANT_PRODUCER_REGS : 88;
template <int FMT, int D>
constexpr int kConsumerRegs =
    FMT == kNone ? 232
                 : (64512 - 128 * kProducerRegs<FMT, D>) / 256 / 8 * 8;
static_assert(128 * kProducerRegs<kInt8, 128> +
                      256 * kConsumerRegs<kInt8, 128> <=
                  168 * WTHREADS &&
                  128 * kProducerRegs<kInt8, 256> +
                          256 * kConsumerRegs<kInt8, 256> <=
                      168 * WTHREADS,
              "the warpgroups share the launch's registers");

// Shared memory of one block, in bytes from a 1024-aligned base. Quantized
// K/V land in the same ring: each tile's payload rows arrive by bulk copy in
// the second half of its K (V) stage and expand in place into the bf16
// tile; a stage's copies complete on pay_full.
template <int D, bool QUANT>
struct FwdSmem {
  static constexpr int WN = FwdTiles<D>::BN;     // kv rows per tile
  static constexpr int STAGES = FwdTiles<D>::STAGES;
  static constexpr bool SPLIT = FwdTiles<D>::SPLIT;
  static constexpr int QT = FwdTiles<D>::BM * D * 2;  // the q tile
  static constexpr int KV = WN * D * 2;          // one K or V tile
  static constexpr int Q = 0;
  static constexpr int K = QT;                   // [STAGES] K tiles
  static constexpr int V = K + STAGES * KV;      // [STAGES] V tiles
  static constexpr int IDS = V + STAGES * KV;    // [STAGES][WN] kv ids
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES] (V's slot, or
  // the stage's); SPLIT also k_empty[STAGES]; quantized also
  // pay_full[STAGES] (the stage's payload copies; SPLIT: K's), and SPLIT
  // quantized v_pay[STAGES] (V's)
  static constexpr int BAR = IDS + STAGES * WN * 4;
  static constexpr int TOTAL =
      BAR + (1 + (3 + SPLIT + QUANT * (1 + SPLIT)) * STAGES) * 8;
  static constexpr int ALLOC = TOTAL + 1024;     // room to align the base
  static_assert(ALLOC <= 232448, "a block has 227 KB of shared memory");
};

// Quantized K/V of one launch (instances with N = D = d only): payloads (B,
// hkv, kv_len, D) bytes and scales (B, hkv, ld) f32, ld at least kv_len
// rounded up to a whole kv tile of the instance (zeros past kv_len; the
// wrapper rounds to 128 rows, two of the wide instance's tiles); null for
// bf16 K/V.
struct QuantKv {
  const uint8_t* k;
  const uint8_t* v;
  const float* ks;
  const float* vs;
  int ld;
};

// ------------------------------------------------------- payload converts

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Two int8 payload bytes (the bytes that `sel` places at bits [7:0] and
// [23:16]) as a bf16x2 word, exactly: each half h = 0x4300 | (x & 0x7F)
// (128 + the low seven bits) plus g = 0xC300 | (x & 0x80) (-128, or -256
// where x is negative), summed by one bf16x2 fma against 1.0; the sum is an
// integer of at most eight bits, so it is exact.
__device__ __forceinline__ uint32_t int8_pair_bf16(uint32_t w, uint32_t sel) {
  const uint32_t lo = prmt(w, 0u, sel);
  const uint32_t m = (lo & 0x007F007Fu) | 0x43004300u;
  const uint32_t g = (lo & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(m), "r"(0x3F803F80u), "r"(g));
  return d;
}

// Two e4m3 payload bytes (the bytes that `sel` places at bits [15:8] and
// [31:24]) as bf16 bits by the TPU kernels' mapping (flash.py:75-79): sign
// << 8 | ((mag << 4) + (120 << 7)), mag 0 a signed zero. t = mag << 4 per
// half; t + 0x7FF0 sets bit 15 exactly where mag != 0, and a byte permute
// in sign-replicate mode spreads that bit over its half as the mask.
__device__ __forceinline__ uint32_t e4m3_pair_bf16(uint32_t w, uint32_t sel) {
  const uint32_t hi = prmt(w, 0u, sel);
  const uint32_t t = (hi >> 4) & 0x07F007F0u;
  const uint32_t nz = prmt(t + 0x7FF07FF0u, 0u, 0xBB99u);
  return ((t + 0x3C003C00u) & nz) | (hi & 0x80008000u);
}

// 16 payload bytes (lowest first) as 16 bf16 values in two 16-byte chunks.
template <int FMT>
__device__ __forceinline__ void payload16_bf16(const uint4& x, uint4& lo,
                                               uint4& hi) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (FMT == kInt8) {
      o[2 * i] = int8_pair_bf16(w[i], 0x4140u);
      o[2 * i + 1] = int8_pair_bf16(w[i], 0x4342u);
    } else {
      o[2 * i] = e4m3_pair_bf16(w[i], 0x1404u);
      o[2 * i + 1] = e4m3_pair_bf16(w[i], 0x3424u);
    }
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void sts16(void* p, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// N: the instance's product width; d: the true head_dim (d <= N, the row
// stride of q, K, V and out).
template <int N, bool WINDOW, bool SEGS, int FMT>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, FwdMasks mk, int hq,
                           int hkv, int q_len, int kv_len, int d, int causal,
                           float scale_log2, int window, QuantKv qk) {
  constexpr bool QUANT = FMT != kNone;
  constexpr int D = tile_cols(N);                // shared-memory tile columns
  static_assert(!QUANT || N == D, "payload rows are whole tile rows");
  using S = FwdSmem<D, QUANT>;
  constexpr int WN = S::WN;                      // kv rows per tile
  // HALVES (512): both consumers take the block's BM = 64 q rows, each
  // computing the whole S and the PV products of its ON = 256 columns
  constexpr bool HALVES = FwdTiles<D>::HALVES;
  static_assert(!QUANT || !HALVES, "no quantized instance above 256");
  constexpr int BM = FwdTiles<D>::BM;            // q rows per block
  constexpr int ON = HALVES ? N / 2 : N;         // O columns a consumer holds
  constexpr int STAGES = S::STAGES;
  constexpr bool SPLIT = S::SPLIT;
  constexpr int BOXES = D / 64;                  // 64-wide column blocks
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;   // V's slot (SPLIT), else the stage
  uint64_t* k_empty = SPLIT ? empty + STAGES : empty;  // K's slot
  uint64_t* pay_full = empty + (SPLIT ? 2 : 1) * STAGES;  // quantized only
  uint64_t* v_pay = SPLIT ? pay_full + STAGES : pay_full;  // V's (SPLIT)
  int* ids = reinterpret_cast<int*>(sm + S::IDS);

  const int tid = threadIdx.x, wg = tid / 128;
  const int qt = mk.tile_order ? mk.tile_order[blockIdx.x]
                               : gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int offset = kv_len - q_len;
  __nv_bfloat16* og = o + (size_t)(b * hq + h) * q_len * d;
  float* lg = lse + (size_t)(b * hq + h) * q_len;
  // jagged: columns end at L (the kv length otherwise), rows at L (q_len)
  const int col_end =
      mk.seq_lens ? min(max(mk.seq_lens[b], 0), kv_len) : kv_len;
  const int row_end = mk.seq_lens ? col_end : q_len;
  if (q0 >= row_end) {  // a jagged tile wholly past its row's length
    write_empty_rows(og, lg, q0, min(BM, q_len - q0), d);
    return;
  }
  const int hi = min(kv_tiles(q0, BM, q_len, kv_len, causal, WN),
                     (col_end + WN - 1) / WN);
  int lo = mk.tile_lo ? max(0, min(mk.tile_lo[qt], hi - 1)) : 0;
  if (WINDOW) lo = window_lo(lo, hi, q0 + offset, window, WN);
  const int n = hi - lo;                         // kv tiles, at least 1
  const int* kv_ids = SEGS ? mk.kv_seg + (size_t)b * kv_len : nullptr;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&k_full[st], QUANT ? PRODUCERS : 1);
      mbar_init(&v_full[st], QUANT ? PRODUCERS : 1);
      mbar_init(&empty[st], CONSUMERS);
      if (SPLIT) mbar_init(&k_empty[st], CONSUMERS);
      if (QUANT) mbar_init(&pay_full[st], 1);
      if (QUANT && SPLIT) mbar_init(&v_pay[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_dealloc<kProducerRegs<FMT, D>>();
    if constexpr (QUANT) {
      const int pt = tid % 128, pw = pt / 32, lane = pt % 32;
      if (pt == 0) {
        mbar_expect_tx(q_full, S::QT);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load_3d(sm + S::Q + c * BM * 128, &tm_q, q_full, 64 * c, q0,
                      b * hq + h);
      }
      // Pass x of a tile: each thread converts one 16-byte payload chunk (a
      // pass is 2 KiB of payload), a warp RPW rows (whole rows up to 128
      // columns; at 256, two of a row's four 64-column blocks, so that a
      // pass covers 16 rows' blocks 0-1 or 2-3). A quarter warp takes two
      // neighbouring rows r (even) and r + 1, four chunks of each: its
      // payload reads hit eight different 16-byte bank groups (head_dim
      // 128: one row's chunks of one 64-column block, the other row's of
      // the other block; 256: of two blocks an odd number apart; 64: the
      // two 64-byte rows), and so do its swizzled bf16 stores (the two
      // rows' swizzles differ).
      constexpr int RPW = BOXES == 4 ? 4 : 8 / BOXES;
      constexpr int PASSES = WN * D / 2048;
      const int quarter = lane >> 3, t8 = lane & 7;
      const int rin =
          pw * RPW + 2 * (quarter / (BOXES == 1 ? 1 : 2)) + (t8 >> 2);
      const int chunk = 2 * (t8 & 3);            // its first bf16 chunk
      const int f = BOXES >= 2 ? ((t8 >> 2) ^ (quarter & 1)) : 0;
      const size_t head = (size_t)(b * hkv + kvh) * kv_len * D;
      // the row and the 64-column block of pass x
      auto row_of = [&](int x) {
        return BOXES == 4 ? (x >> 1) * 16 + rin : x * 4 * RPW + rin;
      };
      auto box_of = [&](int x) {
        return BOXES == 4 ? 2 * (x & 1) + f : BOXES == 2 ? f ^ (x & 1) : 0;
      };
      // the payload chunk of pass x, from the stage's second half
      auto fetch = [&](const unsigned char* tile, int x) {
        return *reinterpret_cast<const uint4*>(
            tile + S::KV / 2 + row_of(x) * D +
            (4 * box_of(x) + (t8 & 3)) * 16);
      };
      // ... converted into the two swizzled bf16 chunks of its row
      auto put = [&](unsigned char* tile, int x, const uint4& raw) {
        const int r = row_of(x);
        uint4 c0, c1;
        payload16_bf16<FMT>(raw, c0, c1);
        unsigned char* row = tile + box_of(x) * WN * 128 + r * 128;
        sts16(row + ((chunk ^ (r & 7)) << 4), c0);
        sts16(row + (((chunk + 1) ^ (r & 7)) << 4), c1);
      };
      // A landed payload tile expands in place: the passes into the half of
      // the tile that the payload does not occupy (head_dim 128: the first
      // 64-column block, where pass x goes to block f ^ (x & 1); 256:
      // blocks 0-1, the even passes; 64: rows [0, 64)) first, while the
      // chunks of the other passes are read into registers; a barrier
      // among the producers; then those. Then the stage's full barrier.
      auto expand = [&](unsigned char* tile, uint64_t* full) {
        constexpr int HALF = PASSES / 2;
        auto pass_of = [&](int k, int second) {
          return BOXES == 4   ? 2 * k + second
                 : BOXES == 2 ? 2 * k + (f ^ second)
                              : k + second * HALF;
        };
        uint4 hold[HALF];
#pragma unroll
        for (int k = 0; k < HALF; ++k) {
          hold[k] = fetch(tile, pass_of(k, 1));
          put(tile, pass_of(k, 0), fetch(tile, pass_of(k, 0)));
        }
        named_bar(5, PRODUCERS);
#pragma unroll
        for (int k = 0; k < HALF; ++k) put(tile, pass_of(k, 1), hold[k]);
        fence_async_smem();  // the generic stores, before wgmma reads them
        mbar_arrive(full);
      };
      const size_t srow = (size_t)(b * hkv + kvh) * qk.ld;
      if constexpr (SPLIT) {
        // The wide instance's ring frees K's and V's slots apart, so their
        // copies land on barriers of their own (pay_full K's, v_pay V's):
        // tile i's K payload once the consumers have freed K's slot of tile
        // i - 2 (k_empty, after its softmax), its V payload once they have
        // freed V's (empty, after its PV product). One elected thread
        // copies a tile's payload rows (those below kv_len; the rest of the
        // half keeps finite stale values, which the mask and p = 0 cover)
        // into the second half of the slot and prefetches its scales into
        // L1, where the consumers read them.
        auto copy = [&](int i, bool is_v) {
          const int st = i % STAGES, kv0 = (lo + i) * WN;
          if (i >= STAGES)
            mbar_wait(is_v ? &empty[st] : &k_empty[st],
                      (i / STAGES - 1) & 1);
          uint64_t* bar = is_v ? &v_pay[st] : &pay_full[st];
          const uint32_t bytes = (uint32_t)min(WN, kv_len - kv0) * D;
          mbar_expect_tx(bar, bytes);
          bulk_load(sm + (is_v ? S::V : S::K) + st * S::KV + S::KV / 2,
                    (is_v ? qk.v : qk.k) + head + (size_t)kv0 * D, bytes,
                    bar);
#pragma unroll
          for (int c = 0; c < WN / 32; ++c)
            prefetch_l1((is_v ? qk.vs : qk.ks) + srow + kv0 + 32 * c);
        };
        // a landed K tile's ids (columns past kv_len are masked whatever
        // their ids) and its expansion; a V tile's expansion
        auto expand_k = [&](int i) {
          const int st = i % STAGES, kv0 = (lo + i) * WN;
          mbar_wait(&pay_full[st], (i / STAGES) & 1);
          if (SEGS && pt < WN)
            ids[st * WN + pt] = kv0 + pt < kv_len ? kv_ids[kv0 + pt] : 0;
          expand(sm + S::K + st * S::KV, &k_full[st]);
        };
        auto expand_v = [&](int i) {
          const int st = i % STAGES;
          mbar_wait(&v_pay[st], (i / STAGES) & 1);
          expand(sm + S::V + st * S::KV, &v_full[st]);
        };
        // The producer's step it runs beside the consumers' step it (tile
        // it's S, tile it - 1's PV): it expands tile it + 1's K and tile
        // it's V, which their step it + 1 needs, then copies tile it + 2's
        // K and tile it + 1's V as step it frees their slots, so a copy
        // has the rest of that step and the next to land.
        if (pt == 0) {
          copy(0, false);
          copy(0, true);
          if (n > 1) copy(1, false);
        }
        expand_k(0);
        for (int it = 0; it < n; ++it) {
          if (it + 1 < n) expand_k(it + 1);
          expand_v(it);
          if (pt == 0) {
            if (it + 2 < n) copy(it + 2, false);
            if (it + 1 < n) copy(it + 1, true);
          }
        }
      } else {
        // One elected thread copies tile i's K and V payload rows (those
        // below kv_len; the rest of the half keeps finite stale values,
        // which the mask and p = 0 cover) into the second halves of its
        // stage, once the stage is free, and prefetches its k and v scales
        // into L1, where the consumers read them.
        auto copy_tile = [&](int i) {
          const int st = i % STAGES, kv0 = (lo + i) * WN;
          if (i >= STAGES) mbar_wait(&empty[st], (i / STAGES - 1) & 1);
          const uint32_t bytes = (uint32_t)min(WN, kv_len - kv0) * D;
          mbar_expect_tx(&pay_full[st], 2 * bytes);
          bulk_load(sm + S::K + st * S::KV + S::KV / 2,
                    qk.k + head + (size_t)kv0 * D, bytes, &pay_full[st]);
          bulk_load(sm + S::V + st * S::KV + S::KV / 2,
                    qk.v + head + (size_t)kv0 * D, bytes, &pay_full[st]);
#pragma unroll
          for (int c = 0; c < WN / 32; ++c) {
            prefetch_l1(qk.ks + srow + kv0 + 32 * c);
            prefetch_l1(qk.vs + srow + kv0 + 32 * c);
          }
        };
        if (pt == 0) copy_tile(0);
        for (int it = 0; it < n; ++it) {
          const int st = it % STAGES, kv0 = (lo + it) * WN;
          // Tile it + 1's stage is that of tile it - 2, which the consumers
          // free at the end of their step it - 1: until then this wait
          // holds tile it's expansion (its barrier waits for thread 0), and
          // their step it waits for tile it's K. Copies issued after the
          // expansion put their own latency there instead, and a thread 0
          // that tests the stage between passes costs the expansion more:
          // both were slower at both benchmark shapes (PERF.md).
          if (pt == 0 && it + 1 < n) copy_tile(it + 1);
          // the stage is free once its copies have landed: its ids
          // (columns past kv_len are masked whatever their ids), then the
          // expansion
          mbar_wait(&pay_full[st], (it / STAGES) & 1);
          if (SEGS) ids[st * WN + pt] = kv0 + pt < kv_len ? kv_ids[kv0 + pt]
                                                           : 0;
          expand(sm + S::K + st * S::KV, &k_full[st]);
          expand(sm + S::V + st * S::KV, &v_full[st]);
        }
      }
    } else if (tid % 128 < 32) {
      const int lane = tid % 32;
      const int bhk = b * hkv + kvh;
      // a tile's ids are 16-byte aligned rows of the source, and a whole
      // number of 16-byte pieces, when kv_len % 4 == 0
      const bool bulk_ids =
          SEGS && kv_len % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(mk.kv_seg) & 15) == 0;
      if (lane == 0) {
        mbar_expect_tx(q_full, S::QT);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load_3d(sm + S::Q + c * BM * 128, &tm_q, q_full, 64 * c, q0,
                      b * hq + h);
      }
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, kv0 = (lo + it) * WN;
        if (it >= STAGES) mbar_wait(&k_empty[st], (it / STAGES - 1) & 1);
        int* tile_ids = ids + st * WN;
        if (SEGS && !bulk_ids) {
          // columns past kv_len are masked whatever their ids
          for (int r = lane; r < WN; r += 32)
            tile_ids[r] = kv0 + r < kv_len ? kv_ids[kv0 + r] : 0;
          __syncwarp();  // lane 0's arrival releases the warp's stores
        }
        if (lane == 0) {
          const uint32_t id_bytes =
              bulk_ids ? (uint32_t)min(WN, kv_len - kv0) * 4u : 0u;
          mbar_expect_tx(&k_full[st], S::KV + id_bytes);
#pragma unroll
          for (int c = 0; c < BOXES; ++c)
            tma_load_3d(sm + S::K + st * S::KV + c * WN * 128, &tm_k,
                        &k_full[st], 64 * c, kv0, bhk);
          if (id_bytes) bulk_load(tile_ids, kv_ids + kv0, id_bytes,
                                  &k_full[st]);
          if (SPLIT && it >= STAGES)
            mbar_wait(&empty[st], (it / STAGES - 1) & 1);
          mbar_expect_tx(&v_full[st], S::KV);
#pragma unroll
          for (int c = 0; c < BOXES; ++c)
            tma_load_3d(sm + S::V + st * S::KV + c * WN * 128, &tm_v,
                        &v_full[st], 64 * c, kv0, bhk);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    regs_alloc<kConsumerRegs<FMT, D>>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    // the warpgroup's first row and its q rows (HALVES: the block's)
    const int r0 = HALVES ? q0 : q0 + wg * 64;
    const unsigned char* qw = sm + S::Q + (HALVES ? 0 : wg * 64 * 128);
    const bool active = r0 < row_end;
    // this thread's rows: qrow (accumulator slots 0, 1 of each 8 columns)
    // and qrow + 8 (slots 2, 3)
    const int qrow = r0 + warp * 16 + lane / 4;
    const int warp_first_pos = r0 + warp * 16 + offset;
    // a tile whose first column lies left of the window edge of the warp's
    // last row pays the window compare
    const int warp_left = warp_first_pos + 15 - window + 1;
    // every tile pays the mask with ids, and in a jagged warpgroup that
    // holds rows past L
    const bool mask_all = SEGS || (mk.seq_lens && r0 + 64 > row_end);
    int qid[2] = {0, 0};
    if (SEGS) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qrow + r * 8;
        if (row < q_len) qid[r] = mk.q_seg[(size_t)b * q_len + row];
      }
    }
    // quantized: this head's k and v scales, read in column pairs without a
    // bound: the wrapper pads the scale rows with zeros to whole 128-column
    // tiles (ops/flash.py::_scale_rows, held at tfa_flash_fwd_quant through
    // scale_ld), and a masked column's p = 0 times a zero scale is 0
    const float* ksh = nullptr;
    const float* vsh = nullptr;
    if constexpr (QUANT) {
      ksh = qk.ks + (size_t)(b * hkv + kvh) * qk.ld;
      vsh = qk.vs + (size_t)(b * hkv + kvh) * qk.ld;
    }
    // the scales of the columns this thread holds at kv0 + 8 jj, one pair
    // (rows of ld >= kv0 + WN; the producer has prefetched the tile's scale
    // lines into L1)
    auto scale_pair = [&](const float* sh, int kv0, int jj) {
      return __ldg(reinterpret_cast<const float2*>(
          sh + kv0 + 8 * jj + 2 * (lane % 4)));
    };

    float oacc[ON / 2];
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) oacc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // per-thread partial sums, quad-reduced last

    mbar_wait(q_full, 0);
    if (active) {
      // q * bf16(sm_scale * log2 e), rounded to bf16 (the TPU kernels' q =
      // (q * c).astype(q.dtype)), in place; rows past q_len are TMA's zeros.
      // HALVES: each consumer folds the boxes of its half of the columns,
      // then both wait for the whole tile
      const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));
#pragma unroll
      for (int c = 0; c < BOXES; ++c) {
        if (HALVES && c / (BOXES / 2) != wg) continue;
        uint4* p = reinterpret_cast<uint4*>(
            const_cast<unsigned char*>(qw) + c * BM * 128);
        for (int i = t; i < 64 * 128 / 16; i += 128) {
          uint4 raw = p[i];
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
          for (int x = 0; x < 8; ++x)
            e[x] = __float2bfloat16_rn(__bfloat162float(e[x]) * qscale);
          p[i] = raw;
        }
      }
      fence_async_smem();  // the generic stores, before wgmma reads them
      if (HALVES)
        named_bar(1, CONSUMERS);
      else
        named_bar(1 + wg, 128);
    }

    // The mask and the online softmax (log2 domain, one quad of lanes per
    // row) of the S tile at kv0, in place: s becomes p, 0 where masked;
    // alpha gets the factor that rescales O. Quantized, s is first
    // multiplied by the k scale of its column, before the mask, so a masked
    // entry stays exactly the mask value.
    auto softmax = [&](float (&s)[WN / 2], int kv0, int st,
                       float (&alpha)[2]) {
      if constexpr (QUANT) {
#pragma unroll
        for (int jj = 0; jj < WN / 8; ++jj) {
          const float2 f = scale_pair(ksh, kv0, jj);
          s[4 * jj + 0] *= f.x;
          s[4 * jj + 1] *= f.y;
          s[4 * jj + 2] *= f.x;
          s[4 * jj + 3] *= f.y;
        }
      }
      const bool need_mask = mask_all || kv0 + WN > col_end ||
                             (causal && kv0 + WN - 1 > warp_first_pos) ||
                             (WINDOW && kv0 < warp_left);
      if (need_mask) {
        const int* tile_ids = ids + st * WN;
#pragma unroll
        for (int jj = 0; jj < WN / 8; ++jj) {
          const int c0 = 8 * jj + 2 * (lane % 4);
          const int2 kv_id = SEGS
                                 ? *reinterpret_cast<const int2*>(tile_ids + c0)
                                 : make_int2(0, 0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kv0 + c0 + (e & 1);
            const int row = qrow + (e >> 1) * 8;
            const bool ok =
                col < col_end && row < row_end &&
                (!causal || col <= row + offset) &&
                (!WINDOW || col > row + offset - window) &&
                (!SEGS || qid[e >> 1] == ((e & 1) ? kv_id.y : kv_id.x));
            if (!ok) s[4 * jj + e] = kMaskValue;
          }
        }
      }
      float m_new[2], keep[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m_run[r];
#pragma unroll
        for (int jj = 0; jj < WN / 8; ++jj)
          mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[r] = mx;
        alpha[r] = ex2(m_run[r] - mx);
        // fully-masked-row guard: a row that has seen only masked columns
        // keeps m at the mask floor, where exp2(s - m) would be 1
        keep[r] = mx > 0.5f * kMaskValue ? 1.f : 0.f;
        m_run[r] = mx;
      }
      float rs[2] = {0.f, 0.f};
      if constexpr (QUANT) {
        // the guard as the subtrahend: exp2(s - inf) is 0 (s is finite),
        // the same p as exp2(s - m) * keep without the product
#pragma unroll
        for (int r = 0; r < 2; ++r)
          m_new[r] = keep[r] != 0.f ? m_new[r] : INFINITY;
      }
#pragma unroll
      for (int jj = 0; jj < WN / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * jj + e] = QUANT ? ex2(s[4 * jj + e] - m_new[e >> 1])
                                : ex2(s[4 * jj + e] - m_new[e >> 1]) *
                                      keep[e >> 1];
        rs[0] += s[4 * jj + 0] + s[4 * jj + 1];
        rs[1] += s[4 * jj + 2] + s[4 * jj + 3];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rs[r];
    };
    // P in bf16 (the TPU kernels cast p before the second dot), packed as
    // the A fragments of the PV product, 16 kv columns each; quantized, p
    // times the v scale of its column in f32 first (the tile at kv0)
    auto pack_p = [&](const float (&s)[WN / 2], uint32_t (&pa)[WN / 16][4],
                      int kv0) {
      if constexpr (QUANT) {
#pragma unroll
        for (int jj = 0; jj < WN / 8; ++jj) {
          const float2 f = scale_pair(vsh, kv0, jj);
          pa[jj / 2][2 * (jj % 2)] =
              pack_bf16(s[4 * jj] * f.x, s[4 * jj + 1] * f.y);
          pa[jj / 2][2 * (jj % 2) + 1] =
              pack_bf16(s[4 * jj + 2] * f.x, s[4 * jj + 3] * f.y);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < WN / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
    };
    // S = Q K^T of the tile in stage st: 64 q rows x WN kv columns
    auto issue_s = [&](float (&s)[WN / 2], int st) {
      const unsigned char* kt = sm + S::K + st * S::KV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss<WN, 0, 0>(
            s, smem_desc(qw + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024),
            smem_desc(kt + (kk / 4) * WN * 128 + (kk % 4) * 32, 16, 1024),
            kk > 0);
      wgmma_commit();
    };
    // O += P V of the tile in stage st, V read MN-major (its rows are the k
    // dimension); HALVES: the consumer's ON columns of V, from box
    // wg * ON / 64 on
    auto issue_pv = [&](uint32_t (&pa)[WN / 16][4], int st) {
      const unsigned char* vt = sm + S::V + st * S::KV +
                                (HALVES ? wg * (ON / 64) * WN * 128 : 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WN / 16; ++kk) {
        wgmma_rs<ON>(oacc, pa[kk],
                     smem_desc(vt + kk * 16 * 128, WN * 128, 1024));
      }
      wgmma_commit();
    };

    // The two consumers take turns to issue their products (FA3's ping-pong):
    // warpgroup w waits on barrier 3 + w for its turn and, once its products
    // are issued, hands the turn to the other on barrier 4 - w, so one
    // consumer's softmax runs while the tensor cores do the other's
    // products. A consumer takes n + 1 turns (one S, n - 1 S and PV pairs,
    // one PV); warpgroup 1 hands the first turn to warpgroup 0 and skips
    // its last hand-over, which no one would wait for.
    auto turn_begin = [&]() { named_bar(3 + wg, CONSUMERS); };
    auto turn_end = [&](bool last) {
      if (!(last && wg == 1)) named_bar_arrive(4 - wg, CONSUMERS);
    };
    if (wg == 1) named_bar_arrive(3, CONSUMERS);

    if (active) {
      // Tile it's S product is issued before tile it - 1's PV product, so
      // tile it's softmax runs while the tensor cores do that PV product
      // (FA3's intra-warpgroup overlap); O is rescaled once PV has landed.
      float s[WN / 2], alpha[2];
      uint32_t pa[WN / 16][4];
      mbar_wait(&k_full[0], 0);
      turn_begin();
      issue_s(s, 0);
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, lo * WN, 0, alpha);  // O is 0: nothing to rescale
      if (SPLIT) mbar_arrive(&k_empty[0]);  // its scores and ids are read
      pack_p(s, pa, lo * WN);
      for (int it = 1; it < n; ++it) {
        const int st = it % STAGES, prev = (it - 1) % STAGES;
        const int kv0 = (lo + it) * WN;
        mbar_wait(&k_full[st], (it / STAGES) & 1);
        mbar_wait(&v_full[prev], ((it - 1) / STAGES) & 1);
        turn_begin();
        issue_s(s, st);
        issue_pv(pa, prev);
        turn_end(false);
        wgmma_wait<1>();  // S, the older group, has landed
        fence_regs(s);
        softmax(s, kv0, st, alpha);
        if (SPLIT) mbar_arrive(&k_empty[st]);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(pa);
        mbar_arrive(&empty[prev]);  // this thread has read stage prev
#pragma unroll
        for (int i = 0; i < ON / 8; ++i) {
          oacc[4 * i + 0] *= alpha[0];
          oacc[4 * i + 1] *= alpha[0];
          oacc[4 * i + 2] *= alpha[1];
          oacc[4 * i + 3] *= alpha[1];
        }
        pack_p(s, pa, kv0);
      }
      const int last = (n - 1) % STAGES;
      mbar_wait(&v_full[last], ((n - 1) / STAGES) & 1);
      turn_begin();
      issue_pv(pa, last);
      turn_end(true);
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pa);
      mbar_arrive(&empty[last]);
    } else {
      // keep the ring's count (arrive on each stage once it has been
      // filled) and take the turns in step with it: the other consumer's
      // turns wait for these, and its stages for these arrivals
      turn_begin();
      turn_end(false);
      for (int it = 0; it < n; ++it) {
        mbar_wait(&k_full[it % STAGES], (it / STAGES) & 1);
        mbar_arrive(&empty[it % STAGES]);
        if (SPLIT) mbar_arrive(&k_empty[it % STAGES]);
        turn_begin();
        turn_end(it == n - 1);
      }
    }

    // an idle warpgroup's rows are empty rows: out 0, the sentinel m * ln2
    if (!active) m_run[0] = m_run[1] = kMaskValue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float l_safe = (l == 0.f || l != l) ? 1.f : l;
      const int row = qrow + r * 8;
      // the first of the consumer's ON columns of out (HALVES: its half)
      const int c0 = HALVES ? wg * ON : 0;
      if (row < q_len) {
        // The columns below d (8-column groups: d is a multiple of 8). At d
        // == N every column, at the constant stride N, with no branch: a
        // branch around each group serializes the divisions (5 % of B1's
        // time at head_dim 128). Below N a branch skips each group past d,
        // its divisions too: computing every group first and storing the
        // ones below d was 8-14 % slower at head_dim 80 and 96 on the
        // 128-wide instance (PERF.md).
        if (d == N) {
#pragma unroll
          for (int i = 0; i < ON / 8; ++i) {
            const int col = c0 + 8 * i + 2 * (lane % 4);
            *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * N + col) =
                __floats2bfloat162_rn(oacc[4 * i + 2 * r] / l_safe,
                                      oacc[4 * i + 2 * r + 1] / l_safe);
          }
        } else {
#pragma unroll
          for (int i = 0; i < ON / 8; ++i)
            if (c0 + 8 * i < d)
              *reinterpret_cast<uint32_t*>(og + (size_t)row * d + c0 + 8 * i +
                                           2 * (lane % 4)) =
                  pack_bf16(oacc[4 * i + 2 * r] / l_safe,
                            oacc[4 * i + 2 * r + 1] / l_safe);
        }
        // the two halves hold the same row statistics: the first writes
        if (lane % 4 == 0 && (!HALVES || wg == 0))
          lg[row] = m_run[r] * kLn2 + logf(l_safe);
      }
    }
  }
}

// One launch of the wgmma kernel of width N at head_dim d: bf16 q (and,
// for FMT kNone, bf16 K/V by TMA); qk the payloads and scales for FMT
// kInt8 / kE4m3 (d == N).
template <int N, bool WINDOW, bool SEGS, int FMT>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, const FwdMasks& mk,
                         const QuantKv& qk, int batch, int hq, int hkv,
                         int q_len, int kv_len, int d, int causal,
                         int window, float scale_log2, cudaStream_t stream) {
  using S = FwdSmem<tile_cols(N), FMT != kNone>;
  constexpr int WN = S::WN;
  const auto kernel = flash_fwd_wgmma_kernel<N, WINDOW, SEGS, FMT>;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(kernel, S::ALLOC, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mkv[2];
  constexpr int BM = FwdTiles<tile_cols(N)>::BM;
  if (!bf16_map(&mq, q, d, q_len, batch * hq, BM))
    return cudaErrorInvalidValue;
  if (FMT == kNone) {
    if (!bf16_map(&mkv[0], k, d, kv_len, batch * hkv, WN) ||
        !bf16_map(&mkv[1], v, d, kv_len, batch * hkv, WN))
      return cudaErrorInvalidValue;
  } else {
    mkv[0] = mkv[1] = mq;  // not read: the producer loads the payloads
  }
  const dim3 grid((q_len + BM - 1) / BM, hq, batch);
  kernel<<<grid, WTHREADS, S::ALLOC, stream>>>(
      mq, mkv[0], mkv[1], static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), mk, hq, hkv, q_len, kv_len, d, causal,
      scale_log2, window, qk);
  return cudaGetLastError();
}

// The instance of width N for the window and the ids of one launch.
template <int N, int FMT>
cudaError_t launch_wgmma_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const FwdMasks& mk,
                             const QuantKv& qk, int batch, int hq, int hkv,
                             int q_len, int kv_len, int d, int causal,
                             int window, float scale_log2, cudaStream_t s) {
  const bool w = window > 0, g = mk.q_seg != nullptr;
  const auto launch = w ? (g ? launch_wgmma<N, true, true, FMT>
                             : launch_wgmma<N, true, false, FMT>)
                        : (g ? launch_wgmma<N, false, true, FMT>
                             : launch_wgmma<N, false, false, FMT>);
  return launch(q, k, v, o, lse, mk, qk, batch, hq, hkv, q_len, kv_len, d,
                causal, window, scale_log2, s);
}

}  // namespace
