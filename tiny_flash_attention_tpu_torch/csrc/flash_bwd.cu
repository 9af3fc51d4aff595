// Flash-attention-2 backward for Hopper (sm_90a): dq, dk and dv.
//
// Replaces the five TPU backward kernels, which compute one contract and
// differ only in TPU scheduling (one pass or two, triangle or work list,
// VMEM-resident or banded):
//   tiny_flash_attention_tpu/ops/flash_tri_bwd.py:302  tri_flash_bwd         (_tri_bwd_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri_bwd.py:583  tri_flash_bwd_banded  (_tri_bwd_band_kernel)
//   tiny_flash_attention_tpu/ops/flash_bwd.py:436      _flash_bwd_fused      (_bwd_fused_kernel)
//   tiny_flash_attention_tpu/ops/flash_bwd.py:560      flash_attention_bwd   (_bwd_dq_kernel)
//   tiny_flash_attention_tpu/ops/flash_bwd.py:609      flash_attention_bwd   (_bwd_dkv_kernel)
//
// Contract: q, out, dout (B, hq, Sq, d) and k, v (B, hkv, Skv, d),
// contiguous, of one dtype (bf16: d any multiple of 8 up to 512, read and
// written at its true width; f32: d 64, 128 or 256); lse (B, hq, Sq) is the
// forward's natural-log LSE in f32. Causal rows sit at position row + Skv -
// Sq. Writes dq like q, and dk, dv like k, summed over the GQA group of
// each kv head. The masks are the forward's (flash_fwd.cu): the window (row
// at position p sees columns [p - window + 1, p]), segment ids (equal ids
// attend), the mask
// value -0.7 * FLT_MAX and p = 0 on rows whose LSE is the empty-row
// sentinel (the TPU kernels' guard). Which tiles a block visits comes from
// a host-built table (ops/flash_bwd.py::bwd_tiles, JAX's work lists): for
// each kv tile the range of q tiles that can see it (causal, window and
// static segment_starts clamp it), and the order of the tiles, longest
// range first. A tile outside every range is never read; its gradients
// are the zeros the accumulators start from.
//
// Arithmetic (the work-list kernels' rounding points, flash_bwd.py:173, so
// the recomputed p matches the LSE that flash_fwd.cu wrote with the same
// fold): s2 = (q * scale_log2 rounded to the input dtype) k^T in f32;
// p = exp2(s2 - lse * log2 e); dp = dout v^T; ds = p (dp - delta) with
// delta = rowsum(dout * out) in f32. The tensor cores take p and ds rounded
// to bf16 and accumulate in f32: dv = sum p^T dout, dk = sm_scale sum ds^T
// q, dq = sm_scale sum ds k, each rounded once at the write.
//
// What bounds it: tensor-core FLOPs, 5 products per visible (row, column)
// pair (s, dp, dv, dk, dq: 2.5x the forward's 4 * D flops). At
// (4, 8, 2048, 128) causal that is 85.9 GFLOP over 989 TF/s = 0.087 ms.
//
// bf16 design: three kernels, one pass over the tiles, 5 products.
//   flash_bwd_prep: one warp per q row: delta = rowsum(dout * out) and the
//     log2 LSE (+inf on empty rows and padding, so p = 0 there) in f32,
//     read from bf16 once, and qs = q * bf16(scale_log2) rounded to bf16:
//     q is scaled once per row, not once per kv tile that reads it.
//   flash_bwd_main: one block per (kv tile of 128 rows, q head, batch):
//     splitting each GQA group across blocks gives 4x the blocks of a kv-
//     head grid, and the blocks are numbered longest band first. K and V
//     of the tile land once by TMA; the q tiles (64 rows of q, qs, dout,
//     with the log2 LSE, delta and q ids) stream through a two-stage ring
//     of TMA loads and mbarriers. Two warpgroups each own 64 kv rows and
//     run wgmma: S^T = K qs^T and dP^T = V dout^T (both operands from
//     shared memory), dV += P^T dout and dK += dS^T q (P^T, dS^T as bf16
//     registers, dout and q read MN-major); dS^T goes to shared memory as
//     bf16 and dQ = dS K (each warpgroup 64 of the 128 head dims; at head
//     dim 64 the two warpgroups' halves of the kv rows, summed in shared
//     memory) is added in f32 into a global accumulator by the TMA bulk
//     reduce-add, in turn (below). At the end dK and dV, in f32, are bulk-
//     stored into the q head's own slots. The accumulators hold each 64-row
//     tile in the order of the wgmma fragments, so both stages of staging
//     are contiguous 16-byte stores. Only tiles that straddle the diagonal,
//     the window's edge or the kv_len edge, or have segment ids, pay the
//     element compare; whether there is a window and whether there are ids
//     are template parameters.
//   flash_bwd_post: dq = bf16(dq_acc * sm_scale), dk = bf16(sum of the
//     group's slots * sm_scale), dv = bf16(sum of the slots), the slots
//     summed in q-head order: the one rounding at the write of JAX's VMEM
//     accumulators.
//   The true head_dim d (hopper.cuh::flash_width picks an instance of width
//   N >= d over tiles of D = 64, 128, 256 or 512 columns; above 128 the
//   main kernel is the wide one, above 256 the one of width 512, below):
//   prep reads and writes rows
//   at stride d, its lanes past d adding 0 to delta in the same order as
//   over a padded row; the main kernel's maps take d, so TMA lands zeros in
//   the tiles' columns past d; S^T and dP^T run N / 16 k-steps, dV and dK
//   are m64nNk16 products (48 floats each at N = 96); dQ keeps its two
//   64-column parts (the zero columns of K give zeros); post writes the
//   columns below d at stride d. The slots and dq_acc stay at D columns,
//   internal. So a call at d is the bits of the call on tensors padded to D,
//   with no pad or slice copy.
// Every f32 sum runs in an order fixed by the shape and the masks, so two
// runs give the same bits (the TPU walks its grid in one order). dK, dV:
// one writer per slot, the group summed in head order by post. dQ: the
// contributions to a q tile are added in a chain, in the rank order of
// their kv tiles (FA3's deterministic mode): the block waits until the
// tile's counter reaches its place in the chain (a host-built table,
// ops/flash_bwd.py::dq_chain), issues its bulk reduce-add, and passes the
// turn when the add is complete, in its next step once that step's first
// two products are issued: the add's round trip hides behind the step's
// loads and those products. A block walks its q tiles from the
// last down: the blocks of lower rank (longer ranges, which end at the same
// or a lower q tile) reach each tile at the same step or earlier, so a
// chain link costs at most one step, once, where an upward walk would make
// kv tile j wait for the steps of all the tiles before it. A block waits
// only on blocks of lower rank, which have lower block indices: they were
// dispatched before it, so they are resident or done and the chain cannot
// deadlock. The last link of a chain sets its counter back to 0, so the
// counters are 0 at every launch (the call zeroes them once with dq_acc).
//
// f32 design (CUDA-core FMAs, never TF32; the f32 gate is 2e-5): the split
// backward of _bwd_dq_kernel/_bwd_dkv_kernel, deterministic, three
// kernels (the f32 path below): flash_bwd_dkv_f32, one block per (64-row kv
// tile, 32-row at head_dim 256, and a run of its q tiles, cut at the
// multiples of FLASH_BWD_F32_SPLIT's rows, q head, batch) into slots of its
// own; flash_bwd_dq_f32, the same over a q-major list; flash_bwd_post_f32,
// the slots summed in a fixed order.
//
// Tile sizes come from tiny_flash_attention_tpu_torch/ops/configs.py as -D
// defines; the build refuses to compile without them.

#include "f32_tiles.cuh"
#include "hopper.cuh"

#if !defined(TFA_BWD_BF16_BLOCK_M) || !defined(TFA_BWD_BF16_BLOCK_N) || \
    !defined(TFA_BWD_BF16_THREADS) || !defined(TFA_BWD_BF16_WIDE_BLOCK_M) || \
    !defined(TFA_BWD_BF16_WIDE_BLOCK_N) ||                                \
    !defined(TFA_BWD_BF16_WIDE_THREADS) ||                                \
    !defined(TFA_BWD_BF16_512_BLOCK_M) ||                                 \
    !defined(TFA_BWD_BF16_512_BLOCK_N) ||                                 \
    !defined(TFA_BWD_BF16_512_THREADS) || !defined(TFA_BWD_F32_BLOCK_M) || \
    !defined(TFA_BWD_F32_BLOCK_N) || !defined(TFA_BWD_F32_THREADS) ||    \
    !defined(TFA_BWD_F32_WIDE_BLOCK_M) ||                                 \
    !defined(TFA_BWD_F32_WIDE_BLOCK_N) || !defined(TFA_BWD_F32_WIDE_THREADS)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

typedef __nv_bfloat16 bf16;

// One tile table (3, n) int32: lo[n], hi[n] (the range [lo, hi) of the
// other side's tiles, empty when hi <= lo), order[n] (the tile of each
// block, longest range first). The bf16 kv-major table goes on with the dQ
// chain: base[n], then pos: tile j's place in the chain of q tile lo[j] +
// i is pos[base[j] + i], then the links of each q tile's chain
// (`chain_len`, after the last tile's pos).
struct Table {
  const int* lo;
  const int* hi;
  const int* order;
  const int* base;
  const int* pos;
  __host__ __device__ Table(const int* t, int n)
      : lo(t), hi(t + n), order(t + 2 * n), base(t + 3 * n),
        pos(t + 4 * n) {}
  __device__ const int* chain_len(int n) const {
    return pos + base[n - 1] + max(hi[n - 1] - lo[n - 1], 0);
  }
};

// ------------------------------------------------------------- bf16 path

constexpr int HM = TFA_BWD_BF16_BLOCK_M;       // q rows per step
constexpr int HN = TFA_BWD_BF16_BLOCK_N;       // kv rows per block
constexpr int HTHREADS = TFA_BWD_BF16_THREADS;  // two warpgroups
static_assert(HM == 64 && HN == 128 && HTHREADS == 256,
              "two warpgroups of 64 kv rows over 64-row q steps");
constexpr int PREP_WARPS = 8;                   // warps per prep block

// Shared memory of the main kernel, in bytes from a 1024-aligned base.
template <int D>
struct Smem {
  static constexpr int KV = HN * D * 2;          // K or V of the tile
  static constexpr int QT = HM * D * 2;          // one q-side tile
  static constexpr int ROWS = 3 * HM * 4;        // lse2, delta, q ids
  static constexpr int STAGE = (3 * QT + ROWS + 1023) / 1024 * 1024;
  static constexpr int K = 0;
  static constexpr int V = KV;
  static constexpr int RING = 2 * KV;            // 2 stages: q, qs, dout
  static constexpr int DST = RING + 2 * STAGE;   // dS^T [HN][HM] bf16
  static constexpr int STG = DST + HN * HM * 2;  // dQ staging, 2 x 16 KB
  static constexpr int BAR = STG + 2 * HM * 64 * 4;
  static constexpr int TOTAL = BAR + 64;
  static constexpr int ALLOC = TOTAL + 1024;     // room to align the base
  static_assert(2 * 2 * 64 * D * 4 <= DST, "dK/dV staging fits the ring");
};

// 16-byte pieces a prep lane reads of each of q, out and dout: one up to
// 256 columns, two at 512 (a row is one warp's there)
__host__ __device__ constexpr int prep_pieces(int d) { return d > 256 ? 2 : 1; }

// q rows a prep warp takes at tiles of D columns
__host__ __device__ constexpr int prep_rows_per_warp(int d) {
  return 32 / (d / 8 / prep_pieces(d));
}

// Rows of d columns (a multiple of 8, at most D): a row's LANES lanes keep
// D's map, those past d reading nothing and adding 0 to delta, so delta's
// sum runs in the order of a row padded to D. At D = 512 a lane takes the
// pieces at columns 8 sub and 256 + 8 sub.
template <int D>
__global__ void __launch_bounds__(32 * PREP_WARPS)
    flash_bwd_prep_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ out,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          bf16* __restrict__ qs, float* __restrict__ lse2,
                          float* __restrict__ delta, int n_bh, int q_len,
                          int q_pad, int d, float scale_log2) {
  constexpr int PIECES = prep_pieces(D);
  constexpr int LANES = D / 8 / PIECES;          // 16 bytes a lane a piece
  constexpr int PER_WARP = prep_rows_per_warp(D);  // rows a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = ((long)blockIdx.x * PREP_WARPS + warp) * PER_WARP +
                   lane / LANES;                 // (bh, r), padded
  if (row >= (long)n_bh * q_pad) return;         // whole rows leave together
  const int bh = (int)(row / q_pad), r = (int)(row % q_pad);
  const int sub = lane % LANES;
  if (r >= q_len) {
    if (sub == 0) {
      lse2[row] = INFINITY;
      delta[row] = 0.f;
    }
    return;
  }
  const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  float dot = 0.f;
#pragma unroll
  for (int piece = 0; piece < PIECES; ++piece) {
    const int col = sub * 8 + piece * (D / PIECES);
    const size_t off = ((size_t)bh * q_len + r) * d + col;
    const bool live = col < d;                   // a piece inside the row
    const uint4 o4 = live ? *reinterpret_cast<const uint4*>(out + off) : zero;
    const uint4 g4 = live ? *reinterpret_cast<const uint4*>(dout + off) : zero;
    uint4 x4 = live ? *reinterpret_cast<const uint4*>(q + off) : zero;
    const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(&o4);
    const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&g4);
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&x4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dot = fmaf(__low2float(o[i]), __low2float(g[i]), dot);
      dot = fmaf(__high2float(o[i]), __high2float(g[i]), dot);
      x[i] = __floats2bfloat162_rn(__low2float(x[i]) * qscale,
                                   __high2float(x[i]) * qscale);
    }
    if (live) *reinterpret_cast<uint4*>(qs + off) = x4;
  }
  // the lanes of one row: every lane of the group took the same branch
  const unsigned group = (LANES == 32 ? 0xffffffffu : (1u << LANES) - 1u)
                         << (lane / LANES * LANES);
#pragma unroll
  for (int m = LANES / 2; m > 0; m >>= 1)
    dot += __shfl_xor_sync(group, dot, m);
  if (sub == 0) {
    const float l2 = lse[(size_t)bh * q_len + r] * kLog2e;
    lse2[row] = l2 > 0.5f * kMaskValue ? l2 : INFINITY;
    delta[row] = dot;
  }
}

// N: the instance's product width (D = tile_cols(N) columns of tiles and
// slots); the tensor maps carry the true head_dim.
template <int N, bool WINDOW, bool SEGS>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_main_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_qs,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          const int* __restrict__ q_seg,
                          const int* __restrict__ kv_seg, const int* table,
                          float* __restrict__ dq_acc,
                          float* __restrict__ dk_acc,
                          float* __restrict__ dv_acc, int* dq_turn,
                          int batch, int hq, int hkv, int q_len, int kv_len,
                          int q_pad, int causal, int window) {
  constexpr int D = tile_cols(N);
  using S = Smem<D>;
  constexpr int BOXES = D / 64;                  // 64-wide column blocks
  constexpr int DQ_PARTS = D / 64;               // dQ chunks per q tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + S::BAR);  // [2]
  uint64_t* kv_bar = full + 2;

  const int n_kvt = (kv_len + HN - 1) / HN;
  const Table tab(table, n_kvt);
  const int rank = blockIdx.x / (hq * batch);    // longest band first
  const int hb = blockIdx.x % (hq * batch);
  const int j = tab.order[rank];
  const int h = hb % hq, b = hb / hq;
  const int kvh = h / (hq / hkv);
  const int lo = tab.lo[j];
  const int n = tab.hi[j] - lo;                  // q tiles to visit
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int bh = b * hq + h;
  // this q head's dK, dV slots of the tile: 2 x 64 rows, f32
  auto dkv_slot = [&](float* acc) {
    return acc + ((size_t)bh * n_kvt + j) * 2 * (64 * D);
  };
  if (n <= 0) {  // no row sees the tile: its gradients are 0
    for (int i = tid; i < 2 * 64 * D / 4; i += HTHREADS) {
      reinterpret_cast<float4*>(dkv_slot(dk_acc))[i] = make_float4(0, 0, 0, 0);
      reinterpret_cast<float4*>(dkv_slot(dv_acc))[i] = make_float4(0, 0, 0, 0);
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int kv0 = j * HN;
  const int offset = kv_len - q_len;
  const size_t rows_base = (size_t)bh * q_pad;   // lse2, delta rows

  auto stage_ptr = [&](int st) { return sm + S::RING + st * S::STAGE; };
  auto load_stage = [&](int st, int qt) {
    unsigned char* p = stage_ptr(st);
    mbar_expect_tx(&full[st], 3 * S::QT + (SEGS ? 3 : 2) * HM * 4);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      tma_load_3d(p + c * HM * 128, &tm_q, &full[st], 64 * c, qt * HM, bh);
      tma_load_3d(p + S::QT + c * HM * 128, &tm_qs, &full[st], 64 * c,
                  qt * HM, bh);
      tma_load_3d(p + 2 * S::QT + c * HM * 128, &tm_do, &full[st], 64 * c,
                  qt * HM, bh);
    }
    float* rows = reinterpret_cast<float*>(p + 3 * S::QT);
    bulk_load(rows, lse2 + rows_base + qt * HM, HM * 4, &full[st]);
    bulk_load(rows + HM, delta + rows_base + qt * HM, HM * 4, &full[st]);
    if (SEGS)
      bulk_load(rows + 2 * HM, q_seg + (size_t)b * q_pad + qt * HM, HM * 4,
                &full[st]);
  };

  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * S::KV);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      tma_load_3d(sm + S::K + c * HN * 128, &tm_k, kv_bar, 64 * c, kv0,
                  b * hkv + kvh);
      tma_load_3d(sm + S::V + c * HN * 128, &tm_v, kv_bar, 64 * c, kv0,
                  b * hkv + kvh);
    }
    load_stage(0, lo + n - 1);  // the q tiles from the last down
    if (n > 1) load_stage(1, lo + n - 2);
  }

  // this thread's kv rows: kr (accumulator slots 0, 1 of each 8-column
  // block) and kr + 8 (slots 2, 3)
  const int kvw = kv0 + wg * 64;                 // the warpgroup's first row
  const int kr = kvw + warp * 16 + lane / 4;
  int kid0 = 0, kid1 = 0;
  if (SEGS) {
    if (kr < kv_len) kid0 = kv_seg[(size_t)b * kv_len + kr];
    if (kr + 8 < kv_len) kid1 = kv_seg[(size_t)b * kv_len + kr + 8];
  }
  const unsigned char* kw = sm + S::K + wg * 64 * 128;  // this WG's K rows
  const unsigned char* vw = sm + S::V + wg * 64 * 128;
  unsigned char* dst = sm + S::DST;
  float* stg = reinterpret_cast<float*>(sm + S::STG) + wg * HM * 64;
  // dQ: with D = 128 each warpgroup takes 64 head dims over all 128 kv
  // rows; with D = 64 all head dims over its own 64 kv rows
  constexpr int DQ_STEPS = D == 128 ? HN / 16 : 64 / 16;
  const int dq_kv0 = D == 128 ? 0 : wg * 64;
  const int dq_box = D == 128 ? wg : 0;
  // who adds dQ: each warpgroup its 64 head dims (D = 128), or warpgroup 0
  // the sum of both halves (D = 64); the turn counter of q tile qt's part
  const bool adds = D == 128 || wg == 0;
  auto turn = [&](int qt) {
    return dq_turn + ((size_t)bh * (q_pad / HM) + qt) * DQ_PARTS + dq_box;
  };
  // this tile's link in each q tile's chain (chain_pos[qt]), and whether
  // it is the chain's last, kept by thread 0 of an adding warpgroup from
  // its add to its pass as link * 2 + last (`passed`). The last link sets
  // the counter back to 0 for the next launch (no one waits on it now)
  // where the others pass the turn on.
  const int* chain_pos = tab.pos + tab.base[j] - lo;
  const int* chain_len = tab.chain_len(n_kvt);
  int passed = 0;
  auto pass_turn = [&](int qt, int code) {
    if (code & 1)
      turn_reset(turn(qt));
    else
      turn_pass(turn(qt));
  };

  float dv[N / 2], dk[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dv[i] = dk[i] = 0.f;

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    const int qt = lo + n - 1 - it, q0 = qt * HM;
    unsigned char* sp = stage_ptr(st);
    const unsigned char* qsm = sp;
    const unsigned char* qss = sp + S::QT;
    const unsigned char* dos = sp + 2 * S::QT;
    const float* l2s = reinterpret_cast<const float*>(sp + 3 * S::QT);
    const float* dls = l2s + HM;
    const int* qids = reinterpret_cast<const int*>(l2s + 2 * HM);
    mbar_wait(&full[st], (it >> 1) & 1);

    // S^T = K qs^T and dP^T = V dout^T: 64 kv rows x 64 q columns each
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss_n64<0, 0>(
          s, smem_desc(kw + (kk / 4) * HN * 128 + (kk % 4) * 32, 16, 1024),
          smem_desc(qss + (kk / 4) * HM * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss_n64<0, 0>(
          dp, smem_desc(vw + (kk / 4) * HN * 128 + (kk % 4) * 32, 16, 1024),
          smem_desc(dos + (kk / 4) * HM * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
    if (t == 0 && adds && it > 0) {
      bulk_wait_all();   // the last step's dQ is in dq_acc (and left the
      pass_turn(qt + 1, passed);  // staging): the next in its chain adds
    }

    // P^T = exp2(S^T - lse2) (0 where masked and on empty rows)
    wgmma_wait<1>();
    fence_regs(s);
    const bool need_mask = SEGS || kvw + 64 > kv_len ||
                           (causal && kvw + 63 > q0 + offset) ||
                           (WINDOW && kvw < q0 + 64 + offset - window);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(l2s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[4 * jj + e] - ((e & 1) ? l2.y : l2.x));
        if (need_mask) {
          const int col = e < 2 ? kr : kr + 8;   // kv position
          const int row = q0 + c + (e & 1);      // q row
          bool ok = col < kv_len && (!causal || col <= row + offset) &&
                    (!WINDOW || col > row + offset - window);
          if (SEGS) ok = ok && qids[c + (e & 1)] == (e < 2 ? kid0 : kid1);
          if (!ok) p = 0.f;
        }
        s[4 * jj + e] = p;
      }
    }
    // dS^T = P^T (dP^T - delta)
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * (lane & 3);
      const float2 dl = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * jj + e] = s[4 * jj + e] * (dp[4 * jj + e] - ((e & 1) ? dl.y : dl.x));
    }
    // P^T and dS^T as bf16 A fragments (the accumulator layout is the
    // A-fragment layout over each 16 columns)
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }

    // dV += P^T dout, dK += dS^T q (dout and q read MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<N>(dv, pa[kk],
                  smem_desc(dos + kk * 16 * 128, HM * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<N>(dk, da[kk],
                  smem_desc(qsm + kk * 16 * 128, HM * 128, 1024));
    wgmma_commit();
    // dS^T to shared memory in the 128-byte swizzle, beside the products
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * (lane & 3);
      const int r0 = wg * 64 + warp * 16 + lane / 4;
      *reinterpret_cast<uint32_t*>(dst + swz(r0, c)) = da[jj / 2][(jj % 2) * 2];
      *reinterpret_cast<uint32_t*>(dst + swz(r0 + 8, c)) =
          da[jj / 2][(jj % 2) * 2 + 1];
    }
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    fence_async_smem();
    __syncthreads();  // dS^T whole; this stage is read by no one
    if (tid == 0 && it + 2 < n) load_stage(st, qt - 2);

    // dQ (64 q rows x 64 head dims) = dS K, read MN-major from dS^T and K
    float dq[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_STEPS; ++kk)
      wgmma_ss_n64<1, 1>(
          dq, smem_desc(dst + (dq_kv0 + 16 * kk) * 128, 64 * 128, 1024),
          smem_desc(sm + S::K + dq_box * HN * 128 + (dq_kv0 + 16 * kk) * 128,
                    HN * 128, 1024),
          kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncthreads();          // and dS^T is read by no one
    float4* stg4 = reinterpret_cast<float4*>(stg);
    if constexpr (D == 64) {  // warpgroup 0 adds warpgroup 1's half
      if (wg == 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          stg4[i * 128 + t] = make_float4(dq[4 * i], dq[4 * i + 1],
                                          dq[4 * i + 2], dq[4 * i + 3]);
      }
      __syncthreads();
      if (wg == 0) {
        const float4* other = stg4 + HM * 64 / 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 o = other[i * 128 + t];
          dq[4 * i] += o.x;
          dq[4 * i + 1] += o.y;
          dq[4 * i + 2] += o.z;
          dq[4 * i + 3] += o.w;
        }
      }
    }
    if (adds) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        stg4[i * 128 + t] = make_float4(dq[4 * i], dq[4 * i + 1],
                                        dq[4 * i + 2], dq[4 * i + 3]);
      fence_async_smem();
      named_bar(1 + wg, 128);
      if (t == 0) {
        int* cnt = turn(qt);
        const int x = chain_pos[qt], last = x + 1 == chain_len[qt];
        turn_wait(cnt, x);
        bulk_reduce_add(dq_acc + (cnt - dq_turn) * (HM * 64), stg,
                        HM * 64 * 4);
        passed = 2 * x + last;
      }
    }
  }
  if (t == 0 && adds) {
    bulk_wait_all();
    pass_turn(lo, passed);
  }

  // dK, dV of the warpgroup's 64 rows, f32 in fragment order, into the
  // q head's slots (the ring and K/V are free now): their first 64 x N
  // floats (fragment order keeps each 8-column group whole), which hold
  // every column that post reads
  __syncthreads();
  float4* dks = reinterpret_cast<float4*>(sm) + wg * 2 * 64 * D / 4;
  float4* dvs = dks + 64 * D / 4;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    dks[i * 128 + t] = make_float4(dk[4 * i], dk[4 * i + 1], dk[4 * i + 2],
                                   dk[4 * i + 3]);
    dvs[i * 128 + t] = make_float4(dv[4 * i], dv[4 * i + 1], dv[4 * i + 2],
                                   dv[4 * i + 3]);
  }
  fence_async_smem();
  named_bar(1 + wg, 128);
  if (t == 0) {
    bulk_store(dkv_slot(dk_acc) + wg * (64 * D), dks, 64 * N * 4);
    bulk_store(dkv_slot(dv_acc) + wg * (64 * D), dvs, 64 * N * 4);
    bulk_wait_read();  // the writes complete before the next launch
  }
}

// ------------------------------------------------------ the wide instance
//
// Head dims in (128, 256] (N = 256, tiles of four 64-column boxes). The
// layout above cannot hold them: a warpgroup's dK and dV of 64 kv rows
// would be 256 f32 registers a thread, and K and V of a 128-row tile (128
// KiB) beside a two-stage ring of q, qs and dout (192 KiB) exceed the
// block's shared memory. So the wide main kernel takes one block per
// (64-row kv tile, q head, batch) (ops/configs.py FLASH_BWD_BF16_WIDE), and
// its two warpgroups share each 64-row q step this way:
//   * S^T = K qs^T and dP^T = V dout^T by q columns: warpgroup w takes the
//     step's q rows [32w, 32w + 32) (m64n32k16 over 16 k-steps each) and
//     computes their P^T and dS^T in f32 at the rounding points above, so
//     no product runs twice and no f32 tile changes hands; both write
//     their columns of P^T and dS^T as bf16 into shared tiles.
//   * dV += P^T dout and dK += dS^T q by head dims: warpgroup w holds
//     columns [128w, 128w + 128) of both, 64 + 64 f32 registers a thread,
//     A from the shared P^T and dS^T tiles (m64n128k16 over 4 k-steps).
//   * dQ = dS K by head dims: warpgroup w the 64-column parts 2w and 2w + 1
//     (m64n64k16 over 4 k-steps each), added into dq_acc in the chain of
//     the q tile: the warpgroup's thread 0 waits for the tile's turn on
//     both parts' counters, a warpgroup barrier, then every thread adds
//     its fragments as float4 atomic adds (one writer at a time, so the sums
//     keep the chain's order; a staging tile would not fit beside the
//     rest, 64 KiB). The turn passes in the next step once its first
//     products are issued: each thread's fence makes its adds visible,
//     then a warpgroup barrier and thread 0's release.
//   * one stage of qs, q and dout (96 KiB) beside K and V (64 KiB): the
//     next q tile's qs is loaded once both warpgroups' S^T have landed,
//     its q, dout and rows once dV and dK have, and a step's S^T is issued
//     once its qs has landed, before the rest. dS^T has two buffers, so
//     one step's dQ and the next step's dS^T need no barrier between them.
// A dK/dV slot holds one 64-row chunk a kv tile in fragment order, the
// 8-column group i of warpgroup w at group 16w + i: post reads it as it
// reads each 64-row half of the 128-row tiles.
constexpr int WHN = TFA_BWD_BF16_WIDE_BLOCK_N;  // kv rows per wide block
static_assert(WHN == 64 && TFA_BWD_BF16_WIDE_BLOCK_M == HM &&
                  TFA_BWD_BF16_WIDE_THREADS == HTHREADS,
              "two warpgroups over a 64-row kv tile and 64-row q steps");

// The instance of width 512 (below): 64-row kv tiles, 32-row q steps.
constexpr int XHM = TFA_BWD_BF16_512_BLOCK_M;   // q rows per step
constexpr int XHN = TFA_BWD_BF16_512_BLOCK_N;   // kv rows per block
static_assert(XHM == 32 && XHN == 64 && TFA_BWD_BF16_512_THREADS == HTHREADS,
              "two warpgroups over a 64-row kv tile and 32-row q steps");

// kv rows of a main-kernel block, and q rows of its step, at tiles of D
// columns
__host__ __device__ constexpr int bwd_kv_rows(int d) {
  return d > 256 ? XHN : d > 128 ? WHN : HN;
}
__host__ __device__ constexpr int bwd_q_rows(int d) {
  return d > 256 ? XHM : HM;
}

template <int D>
struct WideSmem {
  static constexpr int KV = WHN * D * 2;         // K or V of the tile
  static constexpr int QT = HM * D * 2;          // one q-side tile
  static constexpr int K = 0;
  static constexpr int V = KV;
  static constexpr int QS = 2 * KV;              // the q-side stage: qs,
  static constexpr int Q = QS + QT;              // q,
  static constexpr int DO = Q + QT;              // dout,
  static constexpr int ROWS = DO + QT;           // lse2, delta, q ids
  static constexpr int PT = ROWS + 1024;         // P^T [WHN][HM] bf16
  static constexpr int DST = PT + WHN * HM * 2;  // dS^T [2][WHN][HM] bf16
  static constexpr int BAR = DST + 2 * WHN * HM * 2;
  static constexpr int TOTAL = BAR + 64;
  static constexpr int ALLOC = TOTAL + 1024;     // room to align the base
  static_assert(3 * HM * 4 <= 1024, "the rows fit their kilobyte");
  static_assert(ALLOC <= 232448, "a block has 227 KB of shared memory");
};

template <int N, bool WINDOW, bool SEGS>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_qs,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse2,
                          const float* __restrict__ delta,
                          const int* __restrict__ q_seg,
                          const int* __restrict__ kv_seg, const int* table,
                          float* __restrict__ dq_acc,
                          float* __restrict__ dk_acc,
                          float* __restrict__ dv_acc, int* dq_turn,
                          int batch, int hq, int hkv, int q_len, int kv_len,
                          int q_pad, int causal, int window) {
  constexpr int D = tile_cols(N);
  static_assert(D == 256 && N == 256, "the wide instance");
  using S = WideSmem<D>;
  constexpr int BOXES = D / 64;                  // 64-wide column blocks
  constexpr int DQ_PARTS = D / 64;               // dQ chunks per q tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qs_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* full = qs_full + 1;                  // q, dout and the rows
  uint64_t* kv_bar = qs_full + 2;

  const int n_kvt = (kv_len + WHN - 1) / WHN;
  const Table tab(table, n_kvt);
  const int rank = blockIdx.x / (hq * batch);    // longest band first
  const int hb = blockIdx.x % (hq * batch);
  const int j = tab.order[rank];
  const int h = hb % hq, b = hb / hq;
  const int kvh = h / (hq / hkv);
  const int lo = tab.lo[j];
  const int n = tab.hi[j] - lo;                  // q tiles to visit
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int bh = b * hq + h;
  // this q head's dK, dV slot of the tile: 64 rows, f32
  auto dkv_slot = [&](float* acc) {
    return acc + ((size_t)bh * n_kvt + j) * (WHN * D);
  };
  if (n <= 0) {  // no row sees the tile: its gradients are 0
    for (int i = tid; i < WHN * D / 4; i += HTHREADS) {
      reinterpret_cast<float4*>(dkv_slot(dk_acc))[i] = make_float4(0, 0, 0, 0);
      reinterpret_cast<float4*>(dkv_slot(dv_acc))[i] = make_float4(0, 0, 0, 0);
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int kv0 = j * WHN;
  const int offset = kv_len - q_len;
  const size_t rows_base = (size_t)bh * q_pad;   // lse2, delta rows

  auto load_qs = [&](int qt) {
    mbar_expect_tx(qs_full, S::QT);
#pragma unroll
    for (int c = 0; c < BOXES; ++c)
      tma_load_3d(sm + S::QS + c * HM * 128, &tm_qs, qs_full, 64 * c,
                  qt * HM, bh);
  };
  auto load_rest = [&](int qt) {
    mbar_expect_tx(full, 2 * S::QT + (SEGS ? 3 : 2) * HM * 4);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      tma_load_3d(sm + S::Q + c * HM * 128, &tm_q, full, 64 * c, qt * HM,
                  bh);
      tma_load_3d(sm + S::DO + c * HM * 128, &tm_do, full, 64 * c, qt * HM,
                  bh);
    }
    float* rows = reinterpret_cast<float*>(sm + S::ROWS);
    bulk_load(rows, lse2 + rows_base + qt * HM, HM * 4, full);
    bulk_load(rows + HM, delta + rows_base + qt * HM, HM * 4, full);
    if (SEGS)
      bulk_load(rows + 2 * HM, q_seg + (size_t)b * q_pad + qt * HM, HM * 4,
                full);
  };

  if (tid == 0) {
    mbar_init(qs_full, 1);
    mbar_init(full, 1);
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * S::KV);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      tma_load_3d(sm + S::K + c * WHN * 128, &tm_k, kv_bar, 64 * c, kv0,
                  b * hkv + kvh);
      tma_load_3d(sm + S::V + c * WHN * 128, &tm_v, kv_bar, 64 * c, kv0,
                  b * hkv + kvh);
    }
    load_qs(lo + n - 1);  // the q tiles from the last down
    load_rest(lo + n - 1);
  }

  // this thread's kv rows: kr (accumulator slots 0, 1 of each 8-column
  // block) and kr + 8 (slots 2, 3); its warpgroup's q columns of a step
  // (S^T, dP^T) and head dims (dV, dK, dQ)
  const int kr = kv0 + warp * 16 + lane / 4;
  int kid0 = 0, kid1 = 0;
  if (SEGS) {
    if (kr < kv_len) kid0 = kv_seg[(size_t)b * kv_len + kr];
    if (kr + 8 < kv_len) kid1 = kv_seg[(size_t)b * kv_len + kr + 8];
  }
  const int qc = wg * 32;
  const int part0 = 2 * wg;                      // its dQ parts and boxes
  auto turn = [&](int qt, int part) {
    return dq_turn + ((size_t)bh * (q_pad / HM) + qt) * DQ_PARTS + part;
  };
  // this tile's link in each q tile's chain, and the link just added as
  // link * 2 + last (`passed`): the last link sets the counters back to 0
  const int* chain_pos = tab.pos + tab.base[j] - lo;
  const int* chain_len = tab.chain_len(n_kvt);
  int passed = 0;
  // the adds of the step before are visible to the next link
  auto pass_turns = [&](int qt) {
    __threadfence();
    named_bar(1 + wg, 128);
    if (t == 0)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (passed & 1)
          turn_reset(turn(qt, part0 + p));
        else
          turn_pass(turn(qt, part0 + p));
      }
  };

  float dv[64], dk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dv[i] = dk[i] = 0.f;

  const unsigned char* qss = sm + S::QS;
  const unsigned char* qsm = sm + S::Q;
  const unsigned char* dos = sm + S::DO;
  const float* l2s = reinterpret_cast<const float*>(sm + S::ROWS);
  const float* dls = l2s + HM;
  const int* qids = reinterpret_cast<const int*>(l2s + 2 * HM);
  unsigned char* pt = sm + S::PT;
  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n; ++it) {
    const int qt = lo + n - 1 - it, q0 = qt * HM;
    unsigned char* dst = sm + S::DST + (it & 1) * WHN * HM * 2;
    mbar_wait(qs_full, it & 1);

    // S^T = K qs^T and dP^T = V dout^T: 64 kv rows x this warpgroup's 32
    // q columns each; S^T starts before dout and the rows have landed
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<32, 0, 0>(
          s, smem_desc(sm + S::K + (kk / 4) * WHN * 128 + (kk % 4) * 32, 16,
                       1024),
          smem_desc(qss + (kk / 4) * HM * 128 + qc * 128 + (kk % 4) * 32, 16,
                    1024),
          kk > 0);
    wgmma_commit();
    mbar_wait(full, it & 1);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<32, 0, 0>(
          dp, smem_desc(sm + S::V + (kk / 4) * WHN * 128 + (kk % 4) * 32, 16,
                        1024),
          smem_desc(dos + (kk / 4) * HM * 128 + qc * 128 + (kk % 4) * 32, 16,
                    1024),
          kk > 0);
    wgmma_commit();
    if (it > 0) pass_turns(qt + 1);

    // P^T = exp2(S^T - lse2) (0 where masked and on empty rows)
    wgmma_wait<1>();
    fence_regs(s);
    const bool need_mask = SEGS || kv0 + WHN > kv_len ||
                           (causal && kv0 + WHN - 1 > q0 + offset) ||
                           (WINDOW && kv0 < q0 + HM + offset - window);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = qc + 8 * jj + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(l2s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[4 * jj + e] - ((e & 1) ? l2.y : l2.x));
        if (need_mask) {
          const int col = e < 2 ? kr : kr + 8;   // kv position
          const int row = q0 + c + (e & 1);      // q row
          bool ok = col < kv_len && (!causal || col <= row + offset) &&
                    (!WINDOW || col > row + offset - window);
          if (SEGS) ok = ok && qids[c + (e & 1)] == (e < 2 ? kid0 : kid1);
          if (!ok) p = 0.f;
        }
        s[4 * jj + e] = p;
      }
    }
    // dS^T = P^T (dP^T - delta)
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = qc + 8 * jj + 2 * (lane & 3);
      const float2 dl = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * jj + e] = s[4 * jj + e] * (dp[4 * jj + e] - ((e & 1) ? dl.y : dl.x));
    }
    // P^T and dS^T as bf16 into the shared tiles, in the 128-byte swizzle
    // (kv rows, q columns): the A operands of dV and dK
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = qc + 8 * jj + 2 * (lane & 3);
      const int r0 = warp * 16 + lane / 4;
      *reinterpret_cast<uint32_t*>(pt + swz(r0, c)) =
          pack_bf16(s[4 * jj], s[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(pt + swz(r0 + 8, c)) =
          pack_bf16(s[4 * jj + 2], s[4 * jj + 3]);
      *reinterpret_cast<uint32_t*>(dst + swz(r0, c)) =
          pack_bf16(dp[4 * jj], dp[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(dst + swz(r0 + 8, c)) =
          pack_bf16(dp[4 * jj + 2], dp[4 * jj + 3]);
    }
    fence_async_smem();
    __syncthreads();  // P^T and dS^T whole; qs is read by no one
    if (tid == 0 && it + 1 < n) load_qs(qt - 1);

    // dV += P^T dout, dK += dS^T q over this warpgroup's 128 head dims
    // (dout and q read MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HM / 16; ++kk)
      wgmma_ss<128, 0, 1>(
          dv, smem_desc(pt + kk * 32, 16, 1024),
          smem_desc(dos + part0 * HM * 128 + kk * 16 * 128, HM * 128, 1024),
          1);
#pragma unroll
    for (int kk = 0; kk < HM / 16; ++kk)
      wgmma_ss<128, 0, 1>(
          dk, smem_desc(dst + kk * 32, 16, 1024),
          smem_desc(qsm + part0 * HM * 128 + kk * 16 * 128, HM * 128, 1024),
          1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // q, dout, the rows and P^T are read by no one
    if (tid == 0 && it + 1 < n) load_rest(qt - 1);

    // dQ (64 q rows x 64 head dims, two parts) = dS K, read MN-major from
    // dS^T and K, each added in its turn
    const int x = chain_pos[qt];
    passed = 2 * x + (x + 1 == chain_len[qt]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float dq[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WHN / 16; ++kk)
        wgmma_ss<64, 1, 1>(
            dq, smem_desc(dst + 16 * kk * 128, 64 * 128, 1024),
            smem_desc(sm + S::K + (part0 + p) * WHN * 128 + 16 * kk * 128,
                      WHN * 128, 1024),
            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (p == 0) {
        if (t == 0) {
          turn_wait(turn(qt, part0), x);
          turn_wait(turn(qt, part0 + 1), x);
        }
        named_bar(1 + wg, 128);
      }
      float4* acc = reinterpret_cast<float4*>(
          dq_acc + (turn(qt, part0 + p) - dq_turn) * (HM * 64));
#pragma unroll
      for (int i = 0; i < 8; ++i)
        atomicAdd(acc + i * 128 + t,
                  make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2],
                              dq[4 * i + 3]));
    }
  }
  pass_turns(lo);

  // dK, dV of the warpgroup's 128 head dims, f32 in fragment order, into
  // the q head's slot
  float4* dks = reinterpret_cast<float4*>(dkv_slot(dk_acc));
  float4* dvs = reinterpret_cast<float4*>(dkv_slot(dv_acc));
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dks[(16 * wg + i) * 128 + t] = make_float4(dk[4 * i], dk[4 * i + 1],
                                               dk[4 * i + 2], dk[4 * i + 3]);
    dvs[(16 * wg + i) * 128 + t] = make_float4(dv[4 * i], dv[4 * i + 1],
                                               dv[4 * i + 2], dv[4 * i + 3]);
  }
}

// ------------------------------------------------ the instance of width 512
//
// Head dims in (256, 512] (N = 512, tiles of eight 64-column boxes). The
// wide layout cannot hold them: a 64-row kv tile's dK and dV at 512 columns
// are 65,536 f32 values, the whole register file, and K and V (128 KiB)
// beside one 64-row stage of qs, q and dout (192 KiB) exceed the block's
// shared memory. So the grid takes each (64-row kv tile, q head, batch)
// twice, once for each 256-column half of dK, dV and dQ, the two halves
// numbered next to each other (the second reads K, V, qs and dout from
// L2), and a block steps over 32-row q tiles:
//   * S^T = K qs^T and dP^T = V dout^T over all 512 columns, in both
//     halves: warpgroup w takes the step's q rows [16w, 16w + 16)
//     (m64n16k16 over 32 k-steps each) and computes their P and dS in f32
//     at the rounding points above. Both halves run the same products on
//     the same inputs in the same order, so the P and dS they round to
//     bf16 are the same bits. They go to shared tiles [q][kv] (q rows of
//     64 kv columns, the 128-byte swizzle): dV's and dK's A read MN-major,
//     dQ^T's B read K-major.
//   * dV += P^T dout and dK += dS^T q over the half's head dims: warpgroup
//     w holds its 128 columns [256 half + 128w, + 128) of both, 64 + 64 f32
//     registers a thread (m64n128k16 over 2 k-steps).
//   * dQ^T = K^T dS^T over the same head dims (a q step of 32 rows is too
//     few for wgmma's M of 64, so dQ is computed transposed): warpgroup w
//     the 64-column parts 4 half + 2w and + 1 (m64n32k16 over 4 k-steps
//     each, K read MN-major), added into dq_acc by float4 atomics in the
//     chain of the (q tile, part) as in the wide kernel, so the sums keep a
//     fixed order. dq_acc holds each (32-row q tile, part) in the fragment
//     order of dQ^T; post transposes it.
//   * one stage of qs and dout (whole rows, 32 KiB each) and of q (the
//     half's columns, 16 KiB) beside K and V (64 KiB each), P, two dS tiles
//     (4 KiB each): qs is loaded once both warpgroups' S^T have landed, q,
//     dout and the rows once dV and dK have.
// This is 7 products per visible pair where the narrower instances run 5:
// both halves run S^T and dP^T.
struct Smem512 {
  static constexpr int D = 512;
  static constexpr int KV = XHN * D * 2;         // K or V of the tile
  static constexpr int QT = XHM * D * 2;         // qs or dout, whole rows
  static constexpr int K = 0;
  static constexpr int V = KV;
  static constexpr int QS = 2 * KV;              // the q-side stage: qs,
  static constexpr int DO = QS + QT;             // dout,
  static constexpr int Q = DO + QT;              // q (the half's columns),
  static constexpr int ROWS = Q + QT / 2;        // lse2, delta, q ids
  static constexpr int PT = ROWS + 1024;         // P [XHM][XHN] bf16
  static constexpr int DST = PT + XHM * XHN * 2;  // dS [2][XHM][XHN] bf16
  static constexpr int BAR = DST + 2 * XHM * XHN * 2;
  static constexpr int TOTAL = BAR + 64;
  static constexpr int ALLOC = TOTAL + 1024;     // room to align the base
  static_assert(3 * XHM * 4 <= 1024, "the rows fit their kilobyte");
  static_assert(ALLOC <= 232448, "a block has 227 KB of shared memory");
};

template <int N, bool WINDOW, bool SEGS>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_512_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_qs,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse2,
                         const float* __restrict__ delta,
                         const int* __restrict__ q_seg,
                         const int* __restrict__ kv_seg, const int* table,
                         float* __restrict__ dq_acc,
                         float* __restrict__ dk_acc,
                         float* __restrict__ dv_acc, int* dq_turn,
                         int batch, int hq, int hkv, int q_len, int kv_len,
                         int q_pad, int causal, int window) {
  static_assert(N == 512, "the instance of width 512");
  using S = Smem512;
  constexpr int D = S::D;
  constexpr int BOXES = D / 64;                  // 64-wide column blocks
  constexpr int HALF_BOXES = BOXES / 2;          // a half's
  constexpr int DQ_PARTS = D / 64;               // dQ chunks per q tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qs_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* full = qs_full + 1;                  // dout, q and the rows
  uint64_t* kv_bar = qs_full + 2;

  const int n_kvt = (kv_len + XHN - 1) / XHN;
  const Table tab(table, n_kvt);
  const int half = blockIdx.x & 1;               // the halves side by side
  const int rank = (blockIdx.x >> 1) / (hq * batch);  // longest band first
  const int hb = (blockIdx.x >> 1) % (hq * batch);
  const int j = tab.order[rank];
  const int h = hb % hq, b = hb / hq;
  const int kvh = h / (hq / hkv);
  const int lo = tab.lo[j];
  const int n = tab.hi[j] - lo;                  // q tiles to visit
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int bh = b * hq + h;
  // this q head's dK, dV slot of the tile: 64 rows, f32, the 8-column
  // group g of the fragment order at float4 g * 128; this half's groups
  // are [32 half, 32 half + 32)
  auto dkv_half = [&](float* acc) {
    return reinterpret_cast<float4*>(acc + ((size_t)bh * n_kvt + j) *
                                               (XHN * D)) +
           half * 32 * 128;
  };
  if (n <= 0) {  // no row sees the tile: its gradients are 0
    for (int i = tid; i < 32 * 128; i += HTHREADS) {
      dkv_half(dk_acc)[i] = make_float4(0, 0, 0, 0);
      dkv_half(dv_acc)[i] = make_float4(0, 0, 0, 0);
    }
    return;
  }

  const int warp = t / 32, lane = t % 32;
  const int kv0 = j * XHN;
  const int offset = kv_len - q_len;
  const size_t rows_base = (size_t)bh * q_pad;   // lse2, delta rows

  auto load_qs = [&](int qt) {
    mbar_expect_tx(qs_full, S::QT);
#pragma unroll
    for (int c = 0; c < BOXES; ++c)
      tma_load_3d(sm + S::QS + c * XHM * 128, &tm_qs, qs_full, 64 * c,
                  qt * XHM, bh);
  };
  auto load_rest = [&](int qt) {
    mbar_expect_tx(full, S::QT + S::QT / 2 + (SEGS ? 3 : 2) * XHM * 4);
#pragma unroll
    for (int c = 0; c < BOXES; ++c)
      tma_load_3d(sm + S::DO + c * XHM * 128, &tm_do, full, 64 * c,
                  qt * XHM, bh);
#pragma unroll
    for (int c = 0; c < HALF_BOXES; ++c)
      tma_load_3d(sm + S::Q + c * XHM * 128, &tm_q, full,
                  64 * (HALF_BOXES * half + c), qt * XHM, bh);
    float* rows = reinterpret_cast<float*>(sm + S::ROWS);
    bulk_load(rows, lse2 + rows_base + qt * XHM, XHM * 4, full);
    bulk_load(rows + XHM, delta + rows_base + qt * XHM, XHM * 4, full);
    if (SEGS)
      bulk_load(rows + 2 * XHM, q_seg + (size_t)b * q_pad + qt * XHM,
                XHM * 4, full);
  };

  if (tid == 0) {
    mbar_init(qs_full, 1);
    mbar_init(full, 1);
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * S::KV);
#pragma unroll
    for (int c = 0; c < BOXES; ++c) {
      tma_load_3d(sm + S::K + c * XHN * 128, &tm_k, kv_bar, 64 * c, kv0,
                  b * hkv + kvh);
      tma_load_3d(sm + S::V + c * XHN * 128, &tm_v, kv_bar, 64 * c, kv0,
                  b * hkv + kvh);
    }
    load_qs(lo + n - 1);  // the q tiles from the last down
    load_rest(lo + n - 1);
  }

  // this thread's kv rows: kr (accumulator slots 0, 1 of each 8-column
  // block) and kr + 8 (slots 2, 3); its warpgroup's q rows of a step (S^T,
  // dP^T) and head-dim boxes (dV, dK, dQ)
  const int kr = kv0 + warp * 16 + lane / 4;
  int kid0 = 0, kid1 = 0;
  if (SEGS) {
    if (kr < kv_len) kid0 = kv_seg[(size_t)b * kv_len + kr];
    if (kr + 8 < kv_len) kid1 = kv_seg[(size_t)b * kv_len + kr + 8];
  }
  const int qc = wg * 16;
  const int box0 = HALF_BOXES * half + 2 * wg;   // its boxes and dQ parts
  auto turn = [&](int qt, int part) {
    return dq_turn + ((size_t)bh * (q_pad / XHM) + qt) * DQ_PARTS + part;
  };
  // this tile's link in each q tile's chain, and the link just added as
  // link * 2 + last (`passed`): the last link sets the counters back to 0
  const int* chain_pos = tab.pos + tab.base[j] - lo;
  const int* chain_len = tab.chain_len(n_kvt);
  int passed = 0;
  // the adds of the step before are visible to the next link
  auto pass_turns = [&](int qt) {
    __threadfence();
    named_bar(1 + wg, 128);
    if (t == 0)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (passed & 1)
          turn_reset(turn(qt, box0 + p));
        else
          turn_pass(turn(qt, box0 + p));
      }
  };

  float dv[64], dk[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dv[i] = dk[i] = 0.f;

  const unsigned char* qss = sm + S::QS;
  const unsigned char* dos = sm + S::DO;
  const unsigned char* qsm = sm + S::Q;
  const float* l2s = reinterpret_cast<const float*>(sm + S::ROWS);
  const float* dls = l2s + XHM;
  const int* qids = reinterpret_cast<const int*>(l2s + 2 * XHM);
  unsigned char* pt = sm + S::PT;
  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n; ++it) {
    const int qt = lo + n - 1 - it, q0 = qt * XHM;
    unsigned char* dst = sm + S::DST + (it & 1) * XHM * XHN * 2;
    mbar_wait(qs_full, it & 1);

    // S^T = K qs^T and dP^T = V dout^T: 64 kv rows x this warpgroup's 16
    // q rows each; S^T starts before dout and the rows have landed
    float s[8], dp[8];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<16, 0, 0>(
          s, smem_desc(sm + S::K + (kk / 4) * XHN * 128 + (kk % 4) * 32, 16,
                       1024),
          smem_desc(qss + (kk / 4) * XHM * 128 + qc * 128 + (kk % 4) * 32,
                    16, 1024),
          kk > 0);
    wgmma_commit();
    mbar_wait(full, it & 1);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<16, 0, 0>(
          dp, smem_desc(sm + S::V + (kk / 4) * XHN * 128 + (kk % 4) * 32, 16,
                        1024),
          smem_desc(dos + (kk / 4) * XHM * 128 + qc * 128 + (kk % 4) * 32,
                    16, 1024),
          kk > 0);
    wgmma_commit();
    if (it > 0) pass_turns(qt + 1);

    // P^T = exp2(S^T - lse2) (0 where masked and on empty rows)
    wgmma_wait<1>();
    fence_regs(s);
    const bool need_mask = SEGS || kv0 + XHN > kv_len ||
                           (causal && kv0 + XHN - 1 > q0 + offset) ||
                           (WINDOW && kv0 < q0 + XHM + offset - window);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = qc + 8 * jj + 2 * (lane & 3);
      const float2 l2 = *reinterpret_cast<const float2*>(l2s + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[4 * jj + e] - ((e & 1) ? l2.y : l2.x));
        if (need_mask) {
          const int col = e < 2 ? kr : kr + 8;   // kv position
          const int row = q0 + c + (e & 1);      // q row
          bool ok = col < kv_len && (!causal || col <= row + offset) &&
                    (!WINDOW || col > row + offset - window);
          if (SEGS) ok = ok && qids[c + (e & 1)] == (e < 2 ? kid0 : kid1);
          if (!ok) p = 0.f;
        }
        s[4 * jj + e] = p;
      }
    }
    // dS^T = P^T (dP^T - delta)
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = qc + 8 * jj + 2 * (lane & 3);
      const float2 dl = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * jj + e] = s[4 * jj + e] * (dp[4 * jj + e] - ((e & 1) ? dl.y : dl.x));
    }
    // P and dS as bf16 into the shared tiles [q][kv], element by element
    // (a fragment's neighbours are q rows apart there)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = qc + 8 * jj + 2 * (lane & 3) + (e & 1);
        const int r = warp * 16 + lane / 4 + (e < 2 ? 0 : 8);
        *reinterpret_cast<bf16*>(pt + swz(c, r)) =
            __float2bfloat16_rn(s[4 * jj + e]);
        *reinterpret_cast<bf16*>(dst + swz(c, r)) =
            __float2bfloat16_rn(dp[4 * jj + e]);
      }
    fence_async_smem();
    __syncthreads();  // P and dS whole; qs is read by no one
    if (tid == 0 && it + 1 < n) load_qs(qt - 1);

    // dV += P^T dout, dK += dS^T q over this warpgroup's 128 head dims
    // (P, dS, dout and q read MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < XHM / 16; ++kk)
      wgmma_ss<128, 1, 1>(
          dv, smem_desc(pt + kk * 16 * 128, XHN * 128, 1024),
          smem_desc(dos + box0 * XHM * 128 + kk * 16 * 128, XHM * 128, 1024),
          1);
#pragma unroll
    for (int kk = 0; kk < XHM / 16; ++kk)
      wgmma_ss<128, 1, 1>(
          dk, smem_desc(dst + kk * 16 * 128, XHN * 128, 1024),
          smem_desc(qsm + 2 * wg * XHM * 128 + kk * 16 * 128, XHM * 128,
                    1024),
          1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // dout, q, the rows and P are read by no one
    if (tid == 0 && it + 1 < n) load_rest(qt - 1);

    // dQ^T (64 head dims x 32 q rows, two parts) = K^T dS^T, K read
    // MN-major and dS K-major, each added in its turn
    const int x = chain_pos[qt];
    passed = 2 * x + (x + 1 == chain_len[qt]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float dq[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < XHN / 16; ++kk)
        wgmma_ss<32, 1, 0>(
            dq, smem_desc(sm + S::K + (box0 + p) * XHN * 128 + 16 * kk * 128,
                          XHN * 128, 1024),
            smem_desc(dst + kk * 32, 16, 1024), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      if (p == 0) {
        if (t == 0) {
          turn_wait(turn(qt, box0), x);
          turn_wait(turn(qt, box0 + 1), x);
        }
        named_bar(1 + wg, 128);
      }
      float4* acc = reinterpret_cast<float4*>(
          dq_acc + (turn(qt, box0 + p) - dq_turn) * (XHM * 64));
#pragma unroll
      for (int i = 0; i < 4; ++i)
        atomicAdd(acc + i * 128 + t,
                  make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2],
                              dq[4 * i + 3]));
    }
  }
  pass_turns(lo);

  // dK, dV of the warpgroup's 128 head dims, f32 in fragment order, into
  // the q head's slot
  float4* dks = dkv_half(dk_acc) + 16 * wg * 128;
  float4* dvs = dkv_half(dv_acc) + 16 * wg * 128;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dks[i * 128 + t] = make_float4(dk[4 * i], dk[4 * i + 1], dk[4 * i + 2],
                                   dk[4 * i + 3]);
    dvs[i * 128 + t] = make_float4(dv[4 * i], dv[4 * i + 1], dv[4 * i + 2],
                                   dv[4 * i + 3]);
  }
}

// The columns of a dk/dv post chunk at tiles of D columns (two chunks of
// 256 a 64-row tile at 512), and the chunks of a kv tile: its 64-row halves
// at D <= 128, its column halves at 512.
__host__ __device__ constexpr int post_cols(int d) { return d > 256 ? 256 : d; }
__host__ __device__ constexpr int bwd_kv_parts(int d) {
  return d > 256 ? d / post_cols(d) : bwd_kv_rows(d) / 64;
}

// One 64-row chunk of an accumulator in fragment order (64 x cw f32,
// float4 (i, t) holding rows R, R + 8 and columns C, C + 1 of the wgmma
// accumulator layout), scaled and rounded to bf16 through shared memory,
// then written as whole 16-byte pieces of rows of d columns (the columns
// of the chunk below d; d a multiple of 8, so each 8-column group is
// written whole or not at all). `parts` chunks make a tile of
// `tile_rows` rows: the parts of a 64-row tile split its columns into cw
// wide parts (dq at D = 128: the second part holds columns 64 to d; dk and
// dv at D = 512: two of 256), those of a 128-row tile its rows (dk, dv). With `group` > 1 the chunk is the sum of `group` slots,
// `stride` chunks apart, in slot order (dk, dv: the q heads of a kv head).
template <int D, int cw>
__device__ __forceinline__ void post_chunk(const float* acc, bf16* out,
                                           long chunk, int parts,
                                           int tile_rows, int tiles,
                                           int n_rows, int d, float scale,
                                           int group, long stride,
                                           bf16* tile) {
  constexpr int LD = post_cols(D) + 8;           // bf16 per tile row
  const int t = threadIdx.x;
  const int per = parts * tiles;                 // chunks of one head
  const float4* a4 = reinterpret_cast<const float4*>(acc) +
                     ((chunk / per) * group * per + chunk % per) * cw * 16;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int part = (int)(chunk % parts);
  const int col0 = tile_rows == 64 ? part * cw : 0;
  const int cols = min(cw, d - col0);            // the chunk's columns < d
  // Every load is issued, unconditionally, so their latencies overlap: a
  // group past d reloads group 0 (the same lines, cached), its value
  // unused. Loads behind branches cost post 2-5 % at head_dim 128.
  int at[cw / 8];
#pragma unroll
  for (int i = 0; i < cw / 8; ++i) at[i] = (8 * i < cols ? i : 0) * 128 + t;
  float4 av[cw / 8];
#pragma unroll
  for (int i = 0; i < cw / 8; ++i) av[i] = a4[at[i]];
  for (int g = 1; g < group; ++g) {
    const float4* s4 = a4 + g * stride * cw * 16;
#pragma unroll
    for (int i = 0; i < cw / 8; ++i) {
      const float4 x = s4[at[i]];
      av[i].x += x.x;
      av[i].y += x.y;
      av[i].z += x.z;
      av[i].w += x.w;
    }
  }
#pragma unroll
  for (int i = 0; i < cw / 8; ++i) {
    const float4 a = av[i];
    const int c = 8 * i + 2 * (t % 4);
    *reinterpret_cast<__nv_bfloat162*>(tile + r * LD + c) =
        __floats2bfloat162_rn(a.x * scale, a.y * scale);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * LD + c) =
        __floats2bfloat162_rn(a.z * scale, a.w * scale);
  }
  __syncthreads();
  const int tidx = (int)((chunk / parts) % tiles);
  const long bh = chunk / parts / tiles;
  const int row0 = tidx * tile_rows + (tile_rows == 64 ? 0 : part * 64);
  bf16* o = out + (size_t)bh * n_rows * d + col0;
  for (int x = t; x < 64 * cw / 8; x += 128) {
    const int row = x / (cw / 8), c8 = (x % (cw / 8)) * 8;
    if (row0 + row < n_rows && c8 < cols)
      *reinterpret_cast<uint4*>(o + (size_t)(row0 + row) * d + c8) =
          *reinterpret_cast<const uint4*>(tile + row * LD + c8);
  }
}

// One (32-row q tile, 64-column part) chunk of dq_acc at the instance of
// width 512, in the fragment order of dQ^T (float4 (i, t) holds head dims
// R, R + 8 and q rows C, C + 1 of the m64n32 accumulator), scaled and
// rounded to bf16 through shared memory (transposed), then written as whole
// 16-byte pieces of its rows' columns below d.
__device__ __forceinline__ void post_dq_512(const float* acc, bf16* out,
                                            long chunk, int tiles,
                                            int n_rows, int d, float scale,
                                            bf16* tile) {
  constexpr int PARTS = 512 / 64, LD = 64 + 8;
  const int t = threadIdx.x;
  const int col0 = (int)(chunk % PARTS) * 64;
  const int cols = min(64, d - col0);            // the chunk's columns < d
  if (cols <= 0) return;                         // the whole block
  const float4* a4 = reinterpret_cast<const float4*>(acc) +
                     chunk * (XHM * 64 / 4);
  const int hd = 16 * (t / 32) + (t % 32) / 4;
  float4 av[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) av[i] = a4[i * 128 + t];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 8 * i + 2 * (t % 4);
    tile[c * LD + hd] = __float2bfloat16_rn(av[i].x * scale);
    tile[(c + 1) * LD + hd] = __float2bfloat16_rn(av[i].y * scale);
    tile[c * LD + hd + 8] = __float2bfloat16_rn(av[i].z * scale);
    tile[(c + 1) * LD + hd + 8] = __float2bfloat16_rn(av[i].w * scale);
  }
  __syncthreads();
  const int row0 = (int)((chunk / PARTS) % tiles) * XHM;
  const long bh = chunk / PARTS / tiles;
  bf16* o = out + (size_t)bh * n_rows * d + col0;
  for (int x = t; x < XHM * 8; x += 128) {
    const int row = x / 8, c8 = (x % 8) * 8;
    if (row0 + row < n_rows && c8 < cols)
      *reinterpret_cast<uint4*>(o + (size_t)(row0 + row) * d + c8) =
          *reinterpret_cast<const uint4*>(tile + row * LD + c8);
  }
}

// One block of 128 threads per 64-row chunk (32-row dq chunks at D = 512):
// dq's chunks, then dk's, then dv's.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_post_kernel(const float* __restrict__ dq_acc,
                          const float* __restrict__ dk_acc,
                          const float* __restrict__ dv_acc,
                          bf16* __restrict__ dq, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, long n_dq, long n_kv,
                          int q_len, int kv_len, int d, int group,
                          float sm_scale) {
  constexpr int KVR = bwd_kv_rows(D), KV_PARTS = bwd_kv_parts(D);
  constexpr int QR = bwd_q_rows(D), CW = post_cols(D);
  __shared__ __align__(16) bf16 tile[64 * (CW + 8)];
  const long g = blockIdx.x;
  const int n_qt = (q_len + QR - 1) / QR, n_kvt = (kv_len + KVR - 1) / KVR;
  if (g < n_dq) {
    if constexpr (D > 256)
      post_dq_512(dq_acc, dq, g, n_qt, q_len, d, sm_scale, tile);
    else
      post_chunk<D, 64>(dq_acc, dq, g, D / 64, HM, n_qt, q_len, d, sm_scale,
                        1, 0, tile);
  } else if (g < n_dq + n_kv) {
    post_chunk<D, CW>(dk_acc, dk, g - n_dq, KV_PARTS, KVR, n_kvt, kv_len, d,
                      sm_scale, group, (long)KV_PARTS * n_kvt, tile);
  } else {
    post_chunk<D, CW>(dv_acc, dv, g - n_dq - n_kv, KV_PARTS, KVR, n_kvt,
                      kv_len, d, 1.f, group, (long)KV_PARTS * n_kvt, tile);
  }
}

struct Bf16Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  void* qs;
  float *lse2, *delta;
  const int *q_seg, *kv_seg, *table;
  float *dq_acc, *dk_acc, *dv_acc;
  int* dq_turn;
  void *dq, *dk, *dv;
  int batch, hq, hkv, q_len, kv_len, d, causal, window;
  float scale_log2, sm_scale;
};

// The main kernel of the instance of width N: the wide layout above 128,
// the halves above 256.
template <int N, bool WINDOW, bool SEGS>
constexpr auto main_kernel() {
  if constexpr (tile_cols(N) > 256)
    return flash_bwd_512_kernel<N, WINDOW, SEGS>;
  else if constexpr (tile_cols(N) > 128)
    return flash_bwd_wide_kernel<N, WINDOW, SEGS>;
  else
    return flash_bwd_main_kernel<N, WINDOW, SEGS>;
}

// The main kernel's dynamic shared memory at tiles of D columns.
template <int D>
constexpr int main_smem() {
  if constexpr (D > 256)
    return Smem512::ALLOC;
  else if constexpr (D > 128)
    return WideSmem<D>::ALLOC;
  else
    return Smem<D>::ALLOC;
}

template <int N, bool WINDOW, bool SEGS>
cudaError_t launch_main(const Bf16Args& a, cudaStream_t stream) {
  constexpr int D = tile_cols(N), KVR = bwd_kv_rows(D), QR = bwd_q_rows(D);
  constexpr int ALLOC = main_smem<D>();
  static bool smem_set[kMaxDevices] = {};
  const auto kernel = main_kernel<N, WINDOW, SEGS>();
  cudaError_t err = raise_smem_limit(kernel, ALLOC, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mqs, mdo, mk, mv;
  const int bhq = a.batch * a.hq, bhk = a.batch * a.hkv;
  if (!bf16_map(&mq, a.q, a.d, a.q_len, bhq, QR) ||
      !bf16_map(&mqs, a.qs, a.d, a.q_len, bhq, QR) ||
      !bf16_map(&mdo, a.dout, a.d, a.q_len, bhq, QR) ||
      !bf16_map(&mk, a.k, a.d, a.kv_len, bhk, KVR) ||
      !bf16_map(&mv, a.v, a.d, a.kv_len, bhk, KVR))
    return cudaErrorInvalidValue;
  const int n_kvt = (a.kv_len + KVR - 1) / KVR;
  const int q_pad = (a.q_len + QR - 1) / QR * QR;
  const int halves = D > 256 ? 2 : 1;            // blocks a kv tile
  kernel<<<n_kvt * a.hq * a.batch * halves, HTHREADS, ALLOC, stream>>>(
      mq, mqs, mdo, mk, mv, a.lse2, a.delta, a.q_seg, a.kv_seg, a.table,
      a.dq_acc, a.dk_acc, a.dv_acc, a.dq_turn, a.batch, a.hq, a.hkv, a.q_len,
      a.kv_len, q_pad, a.causal, a.window);
  return cudaGetLastError();
}

// The kernels of the instance of width N; stages: 1 prep, 2 main, 4 post
// (chip_smoke.py times them one by one).
template <int N>
cudaError_t launch_bf16(const Bf16Args& a, int stages, cudaStream_t stream) {
  constexpr int D = tile_cols(N), QR = bwd_q_rows(D);
  const int q_pad = (a.q_len + QR - 1) / QR * QR;
  const int n_bh = a.batch * a.hq;
  if (stages & 1) {
    const long rows = (long)n_bh * q_pad;
    const int per_block = PREP_WARPS * prep_rows_per_warp(D);
    flash_bwd_prep_kernel<D><<<(unsigned)((rows + per_block - 1) / per_block),
                               32 * PREP_WARPS, 0, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.out),
        static_cast<const bf16*>(a.dout), a.lse, static_cast<bf16*>(a.qs),
        a.lse2, a.delta, n_bh, a.q_len, q_pad, a.d, a.scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    const bool w = a.window > 0, s = a.q_seg != nullptr;
    const cudaError_t err =
        w ? (s ? launch_main<N, true, true>(a, stream)
               : launch_main<N, true, false>(a, stream))
          : (s ? launch_main<N, false, true>(a, stream)
               : launch_main<N, false, false>(a, stream));
    if (err != cudaSuccess) return err;
  }
  if (stages & 4) {
    constexpr int KVR = bwd_kv_rows(D);
    const int n_kvt = (a.kv_len + KVR - 1) / KVR;
    const long n_dq = (long)n_bh * (q_pad / QR) * (D / 64);  // chunks
    const long n_kv = (long)a.batch * a.hkv * n_kvt * bwd_kv_parts(D);
    flash_bwd_post_kernel<D><<<(unsigned)(n_dq + 2 * n_kv), 128, 0,
                               stream>>>(
        a.dq_acc, a.dk_acc, a.dv_acc, static_cast<bf16*>(a.dq),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n_dq, n_kv,
        a.q_len, a.kv_len, a.d, a.hq / a.hkv, a.sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ----------------------------------------------------------------- f32 path
//
// CUDA-core FMAs in f32 throughout (never TF32). Two kernels and a post,
// over 64 x 64 score tiles and blocks of 256 threads:
//   flash_bwd_dkv_f32: one block per (work item, q head, batch); a work item
//     is a 64-row kv tile and a run of the q tiles that see it, cut at
//     the multiples of FLASH_BWD_F32_SPLIT (ops/flash_bwd.py::f32_work:
//     at fixed tiles, so segment_starts' pruning changes no bit), so the
//     causal band's long ranges split over several blocks and the card
//     fills (192 blocks at (1, 8, 1024) causal against 32 of one block per
//     (kv tile, kv head)). K and V land once; the q tiles (q, dout and their rows' LSE,
//     delta and ids) stream through a two-stage cp.async ring, the next
//     one landing while the current one is used. The block's two halves
//     of 128 threads split each step: the first computes S^T = K qs^T and P
//     and accumulates dV += P^T dout, the second dP^T = V dout^T and dS =
//     P (dP - delta) and accumulates dK += dS^T q. It writes its dK, dV sums
//     to a slot of its own (work item, q head).
//   flash_bwd_dq_f32: the same over a q-major work list: q and dout land
//     once, the kv tiles (K, V and their ids) stream through the ring; one
//     half computes S and P, the other dP and dS, and all 256 threads
//     accumulate dQ += dS K into the item's slot.
//   flash_bwd_post_f32: each output element sums its slots in a fixed
//     order (dq: its q tile's items in range order; dk, dv: the GQA group's
//     q heads in head order, each over its kv tile's items in range order),
//     then scales dq and dk by sm_scale. So two runs give the same bits.
// The products are register tiles fed by 16-byte shared-memory reads: the
// score products keep 8 x 4 outputs a thread (8 rows broadcast across the
// warp, 4 rows 16 apart) and walk the head dim 4 columns at a time, 12
// float4 reads for 128 FMAs; the accumulating products keep 8 x (D / 16)
// (dk/dv, 64 at head_dim 128) or 4 x (D / 16) outputs a thread, 4 (3)
// float4 reads for 64 (32) FMAs. Counted in shared-memory wavefronts a
// warp, by the code (not measured), that is 16 per 4096 FMAs for the
// scores, 6 per 2048 for dK and dV and 5 per 1024 for dQ, where the 4 x 4
// tiles before took 5 per 512 and 20 per 1024 (two-way conflicts):
// 2.5x, 6.7x and 4x fewer. Tiles sit row-major in shared memory, each
// row's 16-byte chunks XOR-swizzled by row % 8, so the cp.async copies
// land unchanged and the strided float4 reads are free of bank conflicts
// (the tiles and products of f32_tiles.cuh, shared with the forward's f32
// body). One block takes
// 231,680 bytes of shared memory at head_dim 128 (K and V of a tile and two
// stages of q and dout are 192 KB in f32), so an SM holds one block of 8
// warps; the ring hides the loads' latency instead. At head_dim 256 (the
// wide instances, BwdF32Tiles<256>) two 64-row tiles that stay would be
// 128 KiB and one stage of two more as much, so the tiles are 32 rows on
// both sides in the same ring (205,952 bytes): the score tiles keep 4 x 2
// outputs a thread, dK and dV 4 x 16 (64, as at 128), and dQ's threads
// split its 256 columns in two parts of 128, 4 x 8 a thread.

static_assert(TFA_BWD_F32_BLOCK_M == 64 && TFA_BWD_F32_BLOCK_N == 64 &&
                  TFA_BWD_F32_WIDE_BLOCK_M == 32 &&
                  TFA_BWD_F32_WIDE_BLOCK_N == 32 &&
                  TFA_BWD_F32_THREADS == 256 &&
                  TFA_BWD_F32_WIDE_THREADS == 256,
              "two halves of 128 threads over 64 x 64 (wide: 32 x 32) score "
              "tiles");
constexpr int FTHREADS = TFA_BWD_F32_THREADS;

// The f32 tiles at head_dim D: FT rows on both sides (FLASH_BWD_F32, or
// FLASH_BWD_F32_WIDE above 128). A half's thread (a, g) = (u / 16, u % 16)
// owns rows RW a + [0, RW) and columns g + 16 [0, CW) of a score tile and
// rows RW a + [0, RW) of dK or dV; dQ's 256 threads take QP column parts of
// D / QP, rows 4 (t / 16) + [0, 4) of the part's 4 FT threads.
template <int D>
struct BwdF32Tiles {
  static constexpr int FT =
      D > 128 ? TFA_BWD_F32_WIDE_BLOCK_M : TFA_BWD_F32_BLOCK_M;
  static constexpr int RW = FT / 8, CW = FT / 16, QP = 64 / FT;
};

// The LSE in the log2 domain, or +inf on rows that carry the empty-row
// sentinel, so that exp2(s - lse2) is 0 there.
__device__ __forceinline__ float lse2_of(float lse) {
  const float l2 = lse * kLog2e;
  return l2 > 0.5f * kMaskValue ? l2 : INFINITY;
}

// Shared memory of an f32 block, in floats: two tiles that stay (K, V or q,
// dout), a two-stage ring of two tiles, two FT x FT score tiles (P and dS),
// and the rows: for each ring stage and for the tiles that stay, three of
// FT (LSE, delta, ids; or ids).
template <int D>
struct F32Smem {
  static constexpr int FT = BwdF32Tiles<D>::FT;
  static constexpr int TILE = FT * D;
  static constexpr int STAY = 0;                 // [2][TILE]
  static constexpr int RING = 2 * TILE;          // [2 stages][2][TILE]
  static constexpr int P = RING + 4 * TILE;      // [FT][FT]
  static constexpr int DS = P + FT * FT;         // [FT][FT]
  static constexpr int ROWS = DS + FT * FT;      // [3][3][FT]
  static constexpr int TOTAL = ROWS + 9 * FT;
  static constexpr int BYTES = TOTAL * 4;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

// The accumulator's rows RW * a + k of a slot of W-wide rows, its C / 16
// columns in chunks e + 16 cc (C = W, or a column part: slot then points at
// the part's first column), row-major
template <int W, int RW, int C = W>
__device__ __forceinline__ void store_slot(float* slot,
                                           const float (&acc)[RW][C / 16],
                                           int a, int e) {
#pragma unroll
  for (int k = 0; k < RW; ++k)
#pragma unroll
    for (int cc = 0; cc < C / 64; ++cc)
      *reinterpret_cast<float4*>(slot + (RW * a + k) * W +
                                 4 * (e + 16 * cc)) =
          make_float4(acc[k][4 * cc], acc[k][4 * cc + 1], acc[k][4 * cc + 2],
                      acc[k][4 * cc + 3]);
}

// Whether q row `row` sees kv column `col` under the causal mask (with the
// decode offset), the window and the ids (qid, kid; equal when off).
__device__ __forceinline__ bool visible(int row, int col, int q_len,
                                        int kv_len, int causal, int window,
                                        int qid, int kid) {
  const int pos = row + kv_len - q_len;
  return row < q_len && col < kv_len && (!causal || col <= pos) &&
         (window <= 0 || col > pos - window) && qid == kid;
}

template <int D>
__global__ void __launch_bounds__(FTHREADS, 1)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ q_seg,
                             const int* __restrict__ kv_seg, const int* work,
                             int n_items, float* __restrict__ dk_slots,
                             float* __restrict__ dv_slots, int batch, int hq,
                             int hkv, int q_len, int kv_len, int causal,
                             int window, float scale_log2) {
  using S = F32Smem<D>;
  constexpr int FT = S::FT;
  constexpr int RW = BwdF32Tiles<D>::RW, CW = BwdF32Tiles<D>::CW;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm + S::STAY;
  float* vs = ks + S::TILE;
  int* kids = reinterpret_cast<int*>(fsm + S::ROWS + 6 * FT);

  const Work wk(work, n_items);
  const int n_bh = batch * hq;
  const int item = wk.order[blockIdx.x / n_bh];
  const int bh = blockIdx.x % n_bh;
  const int h = bh % hq, b = bh / hq;
  const int kvh = h / (hq / hkv);
  const int kv0 = wk.tile[item] * FT, lo = wk.lo[item];
  const int n = max(0, wk.hi[item] - lo);        // q tiles to visit
  const int tid = threadIdx.x, half = tid / 128, u = tid % 128;
  const int a = u / 16, g = u % 16;              // this thread's row groups
  const size_t head = (size_t)bh * q_len;
  const size_t kv_base = (size_t)(b * hkv + kvh) * kv_len * D;
  const bool segs = q_seg != nullptr;
  const float* qh = q + head * D;
  const float* doh = dout + head * D;

  auto ring = [&](int st) { return fsm + S::RING + st * 2 * S::TILE; };
  auto rows = [&](int st) { return fsm + S::ROWS + st * 3 * FT; };
  // q tile `it` of the range (q, dout, LSE, delta, ids) into stage it % 2
  auto stage_q = [&](int it) {
    const int q0 = (lo + it) * FT, st = it % 2;
    stage_tile<D, FT, FTHREADS>(ring(st), qh, q0, q_len, tid);
    stage_tile<D, FT, FTHREADS>(ring(st) + S::TILE, doh, q0, q_len, tid);
    if (tid < FT) stage_row(rows(st), lse + head, q0, q_len, tid);
    else if (tid < 2 * FT)
      stage_row(rows(st) + FT, delta + head, q0, q_len, tid - FT);
    else if (segs && tid < 3 * FT)
      stage_row(rows(st) + 2 * FT, q_seg + (size_t)b * q_len, q0, q_len,
                tid - 2 * FT);
  };

  stage_tile<D, FT, FTHREADS>(ks, k + kv_base, kv0, kv_len, tid);
  stage_tile<D, FT, FTHREADS>(vs, v + kv_base, kv0, kv_len, tid);
  if (segs && tid < FT)
    stage_row(kids, kv_seg + (size_t)b * kv_len, kv0, kv_len, tid);
  if (n > 0) stage_q(0);
  cp_async_commit();

  float acc[RW][D / 16];                         // dV (half 0) or dK (half 1)
#pragma unroll
  for (int x = 0; x < RW; ++x)
#pragma unroll
    for (int y = 0; y < D / 16; ++y) acc[x][y] = 0.f;
  float* P = fsm + S::P;                         // [q][kv]
  float* DS = fsm + S::DS;                       // [q][kv]

  for (int it = 0; it < n; ++it) {
    const int st = it % 2, q0 = (lo + it) * FT;
    if (it + 1 < n) {
      stage_q(it + 1);   // lands while this step runs
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();     // stage st (and K, V) landed for every thread
    const float* qt = ring(st);
    const float* dot = qt + S::TILE;
    const float* rw = rows(st);
    const int* qids = reinterpret_cast<const int*>(rw + 2 * FT);

    // S^T (kv x q) with q folded as it is read, or dP^T
    float sc[RW][CW];
    if (half == 0)
      score_tile<D, RW, CW, false, true>(sc, ks, qt, scale_log2, a, g);
    else
      score_tile<D, RW, CW, false, false>(sc, vs, dot, 1.f, a, g);
    if (half == 0) {     // P^T, stored as P [q][kv]
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int qc = g + 16 * i;
        const float l2 = lse2_of(rw[qc]);
        float p[RW];
#pragma unroll
        for (int x = 0; x < RW; ++x) {
          const int col = kv0 + RW * a + x;
          const bool ok = visible(q0 + qc, col, q_len, kv_len, causal,
                                  window, segs ? qids[qc] : 0,
                                  segs ? kids[RW * a + x] : 0);
          p[x] = ok ? exp2f(sc[x][i] - l2) : 0.f;
        }
#pragma unroll
        for (int h4 = 0; h4 < RW / 4; ++h4)
          *reinterpret_cast<float4*>(P + sw<FT>(qc, RW * a + 4 * h4)) =
              make_float4(p[4 * h4], p[4 * h4 + 1], p[4 * h4 + 2],
                          p[4 * h4 + 3]);
      }
    }
    __syncthreads();     // P written
    if (half == 1) {     // dS = P (dP - delta), stored [q][kv]
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int qc = g + 16 * i;
        const float dl = rw[FT + qc];
#pragma unroll
        for (int h4 = 0; h4 < RW / 4; ++h4) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              P + sw<FT>(qc, RW * a + 4 * h4));
          *reinterpret_cast<float4*>(DS + sw<FT>(qc, RW * a + 4 * h4)) =
              make_float4(p4.x * (sc[4 * h4][i] - dl),
                          p4.y * (sc[4 * h4 + 1][i] - dl),
                          p4.z * (sc[4 * h4 + 2][i] - dl),
                          p4.w * (sc[4 * h4 + 3][i] - dl));
        }
      }
      named_bar(1, 128);  // dS written by the half that reads it
      accumulate<D, RW, FT, FT>(acc, DS, qt, a, g);    // dK += dS^T q
    } else {
      accumulate<D, RW, FT, FT>(acc, P, dot, a, g);    // dV += P^T dout
    }
    __syncthreads();     // stage st, P and dS are no longer read
  }

  cp_async_wait<0>();    // an empty range: K and V still in flight
  const size_t slot = ((size_t)item * n_bh + bh) * FT * D;
  store_slot<D, RW>((half == 0 ? dv_slots : dk_slots) + slot, acc, a, g);
}

template <int D>
__global__ void __launch_bounds__(FTHREADS, 1)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ q_seg,
                            const int* __restrict__ kv_seg, const int* work,
                            int n_items, float* __restrict__ dq_slots,
                            int batch, int hq, int hkv, int q_len,
                            int kv_len, int causal, int window,
                            float scale_log2) {
  using S = F32Smem<D>;
  constexpr int FT = S::FT;
  constexpr int RW = BwdF32Tiles<D>::RW, CW = BwdF32Tiles<D>::CW;
  constexpr int QC = D / BwdF32Tiles<D>::QP;     // dQ columns of a part
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm + S::STAY;
  float* dos = qs + S::TILE;
  float* qrows = fsm + S::ROWS + 6 * FT;         // LSE, delta, q ids

  const Work wk(work, n_items);
  const int n_bh = batch * hq;
  const int item = wk.order[blockIdx.x / n_bh];
  const int bh = blockIdx.x % n_bh;
  const int h = bh % hq, b = bh / hq;
  const int kvh = h / (hq / hkv);
  const int q0 = wk.tile[item] * FT, lo = wk.lo[item];
  const int n = max(0, wk.hi[item] - lo);        // kv tiles to visit
  const int tid = threadIdx.x, half = tid / 128, u = tid % 128;
  const int a = u / 16, g = u % 16;
  const size_t head = (size_t)bh * q_len;
  const size_t kv_base = (size_t)(b * hkv + kvh) * kv_len * D;
  const bool segs = q_seg != nullptr;

  auto ring = [&](int st) { return fsm + S::RING + st * 2 * S::TILE; };
  auto kids = [&](int st) {
    return reinterpret_cast<int*>(fsm + S::ROWS + st * 3 * FT);
  };
  auto stage_kv = [&](int it) {
    const int kv0 = (lo + it) * FT, st = it % 2;
    stage_tile<D, FT, FTHREADS>(ring(st), k + kv_base, kv0, kv_len, tid);
    stage_tile<D, FT, FTHREADS>(ring(st) + S::TILE, v + kv_base, kv0,
                                kv_len, tid);
    if (segs && tid < FT)
      stage_row(kids(st), kv_seg + (size_t)b * kv_len, kv0, kv_len, tid);
  };

  stage_tile<D, FT, FTHREADS>(qs, q + head * D, q0, q_len, tid);
  stage_tile<D, FT, FTHREADS>(dos, dout + head * D, q0, q_len, tid);
  if (tid < FT) stage_row(qrows, lse + head, q0, q_len, tid);
  else if (tid < 2 * FT) stage_row(qrows + FT, delta + head, q0, q_len,
                                   tid - FT);
  else if (segs && tid < 3 * FT)
    stage_row(qrows + 2 * FT, q_seg + (size_t)b * q_len, q0, q_len,
              tid - 2 * FT);
  if (n > 0) stage_kv(0);
  cp_async_commit();

  // dQ: column part `part` (QC columns from part * QC), rows 4 * a2 + [0, 4),
  // columns of chunks e2 + 16 c
  const int part = tid / (4 * FT), a2 = tid % (4 * FT) / 16, e2 = tid % 16;
  float acc[4][QC / 16];
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < QC / 16; ++y) acc[x][y] = 0.f;
  float* PT = fsm + S::P;                        // P^T, then dS^T [kv][q]
  const int* qids = reinterpret_cast<const int*>(qrows + 2 * FT);

  for (int it = 0; it < n; ++it) {
    const int st = it % 2, kv0 = (lo + it) * FT;
    if (it + 1 < n) {
      stage_kv(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ring(st);
    const float* vt = kt + S::TILE;
    const int* kid = kids(st);

    // S (q x kv) with q folded as it is read, or dP
    float sc[RW][CW];
    if (half == 0)
      score_tile<D, RW, CW, true, false>(sc, qs, kt, scale_log2, a, g);
    else
      score_tile<D, RW, CW, false, false>(sc, dos, vt, 1.f, a, g);
    if (half == 0) {     // P, stored as P^T [kv][q]
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int kc = g + 16 * i;
        float p[RW];
#pragma unroll
        for (int x = 0; x < RW; ++x) {
          const int row = q0 + RW * a + x;
          const bool ok = visible(row, kv0 + kc, q_len, kv_len, causal,
                                  window, segs ? qids[RW * a + x] : 0,
                                  segs ? kid[kc] : 0);
          p[x] = ok ? exp2f(sc[x][i] - lse2_of(qrows[RW * a + x])) : 0.f;
        }
#pragma unroll
        for (int h4 = 0; h4 < RW / 4; ++h4)
          *reinterpret_cast<float4*>(PT + sw<FT>(kc, RW * a + 4 * h4)) =
              make_float4(p[4 * h4], p[4 * h4 + 1], p[4 * h4 + 2],
                          p[4 * h4 + 3]);
      }
    }
    __syncthreads();     // P^T written
    if (half == 1) {     // dS^T = P^T (dP^T - delta), in place
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        const int kc = g + 16 * i;
#pragma unroll
        for (int h4 = 0; h4 < RW / 4; ++h4) {
          float4* p4 =
              reinterpret_cast<float4*>(PT + sw<FT>(kc, RW * a + 4 * h4));
          const float* dl = qrows + FT + RW * a + 4 * h4;
          float4 x4 = *p4;
          x4.x *= sc[4 * h4][i] - dl[0];
          x4.y *= sc[4 * h4 + 1][i] - dl[1];
          x4.z *= sc[4 * h4 + 2][i] - dl[2];
          x4.w *= sc[4 * h4 + 3][i] - dl[3];
          *p4 = x4;
        }
      }
    }
    __syncthreads();     // dS^T written
    accumulate<QC, 4, FT, FT, D>(acc, PT, kt + part * QC, a2,
                                 e2);            // dQ += dS K
    __syncthreads();     // stage st and dS^T are no longer read
  }

  cp_async_wait<0>();    // an empty range: q and dout still in flight
  store_slot<D, 4, QC>(
      dq_slots + ((size_t)item * n_bh + bh) * FT * D + part * QC, acc, a2,
      e2);
}

// One thread per float4 of dq, then of dk, then of dv: the sum of its
// slots in a fixed order, scaled.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_post_f32_kernel(const float4* __restrict__ dq_slots,
                              const float4* __restrict__ dk_slots,
                              const float4* __restrict__ dv_slots,
                              const int* q_work, int q_items,
                              const int* kv_work, int kv_items,
                              float4* __restrict__ dq, float4* __restrict__ dk,
                              float4* __restrict__ dv, int batch, int hq,
                              int hkv, int q_len, int kv_len,
                              float sm_scale) {
  constexpr int C4 = D / 4, FT = BwdF32Tiles<D>::FT;
  const long n_dq = (long)batch * hq * q_len * C4;
  const long n_kv = (long)batch * hkv * kv_len * C4;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int n_bh = batch * hq;
  if (i >= n_dq + 2 * n_kv) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  auto add = [&](const float4* slots, int item, int bh, int r, int c) {
    const float4 x = slots[(((size_t)item * n_bh + bh) * FT + r) * C4 + c];
    s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
  };
  if (i < n_dq) {
    const int c = (int)(i % C4);
    const long row = i / C4;
    const int bh = (int)(row / q_len), r = (int)(row % q_len);
    const Work wk(q_work, q_items);
    for (int it = wk.first[r / FT]; it < wk.first[r / FT + 1]; ++it)
      add(dq_slots, it, bh, r % FT, c);
    dq[i] = make_float4(s.x * sm_scale, s.y * sm_scale, s.z * sm_scale,
                        s.w * sm_scale);
    return;
  }
  const bool is_k = i < n_dq + n_kv;
  const long j = i - n_dq - (is_k ? 0 : n_kv);
  const int c = (int)(j % C4);
  const long row = j / C4;
  const int bkv = (int)(row / kv_len), r = (int)(row % kv_len);
  const int b = bkv / hkv, kvh = bkv % hkv, group = hq / hkv;
  const Work wk(kv_work, kv_items);
  for (int gi = 0; gi < group; ++gi)
    for (int it = wk.first[r / FT]; it < wk.first[r / FT + 1]; ++it)
      add(is_k ? dk_slots : dv_slots, it, b * hq + kvh * group + gi, r % FT,
          c);
  const float f = is_k ? sm_scale : 1.f;
  (is_k ? dk : dv)[j] = make_float4(s.x * f, s.y * f, s.z * f, s.w * f);
}

struct F32Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  const int *q_seg, *kv_seg, *kv_work, *q_work;
  int kv_items, q_items;
  float *dq_slots, *dk_slots, *dv_slots;
  float *dq, *dk, *dv;
  int batch, hq, hkv, q_len, kv_len, causal, window;
  float scale_log2, sm_scale;
};

// stages: 1 the dq kernel, 2 the dk/dv kernel, 4 the post.
template <int D>
cudaError_t launch_f32(const F32Args& a, int stages, cudaStream_t stream) {
  constexpr int FT = BwdF32Tiles<D>::FT;
  if (a.kv_items < (a.kv_len + FT - 1) / FT ||
      a.q_items < (a.q_len + FT - 1) / FT)
    return cudaErrorInvalidValue;
  const int smem = F32Smem<D>::BYTES;
  const int n_bh = a.batch * a.hq;
  if (stages & 1) {
    static bool smem_set[kMaxDevices] = {};
    cudaError_t err =
        raise_smem_limit(flash_bwd_dq_f32_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<D><<<a.q_items * n_bh, FTHREADS, smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.q_seg, a.kv_seg, a.q_work,
        a.q_items, a.dq_slots, a.batch, a.hq, a.hkv, a.q_len, a.kv_len,
        a.causal, a.window, a.scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    static bool smem_set[kMaxDevices] = {};
    cudaError_t err =
        raise_smem_limit(flash_bwd_dkv_f32_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_f32_kernel<D>
        <<<a.kv_items * n_bh, FTHREADS, smem, stream>>>(
            a.q, a.k, a.v, a.dout, a.lse, a.delta, a.q_seg, a.kv_seg,
            a.kv_work, a.kv_items, a.dk_slots, a.dv_slots, a.batch, a.hq,
            a.hkv, a.q_len, a.kv_len, a.causal, a.window, a.scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 4) {
    const long n = ((long)n_bh * a.q_len + 2L * a.batch * a.hkv * a.kv_len) *
                   (D / 4);
    flash_bwd_post_f32_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0,
                                   stream>>>(
        reinterpret_cast<const float4*>(a.dq_slots),
        reinterpret_cast<const float4*>(a.dk_slots),
        reinterpret_cast<const float4*>(a.dv_slots), a.q_work, a.q_items,
        a.kv_work, a.kv_items, reinterpret_cast<float4*>(a.dq),
        reinterpret_cast<float4*>(a.dk), reinterpret_cast<float4*>(a.dv),
        a.batch, a.hq, a.hkv, a.q_len, a.kv_len, a.sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Returns a cudaError_t: 0 when the kernels were launched. dtype 0 (bf16):
// `stages` 1 flash_bwd_prep (delta, lse2 and qs from q, out, dout, lse), 2
// flash_bwd_main (into dq_acc and the dq_turn counters, both zeroed by the
// caller, one counter per (batch, q head, 64-row q tile, 64 head dims),
// which the kernel leaves at 0; and dk_acc, dv_acc: (batch, hq,
// ceil(kv_len / R), R / 64, 64 * D) f32 each, all written, R the kv rows
// of a block: 128, 64 at the wide instance, D its tile columns), 4
// flash_bwd_post (dq, dk, dv); q_seg is padded to whole 64-row tiles and
// kv_table is the (3, ceil(kv_len / R)) table of 64-row q tiles followed
// by its dQ chain (base, pos, chain lengths). dtype 1 (f32): `stages` 1
// the dq kernel (q_table: the q-major work list of q_items items over
// 64-row tiles, 32-row at head_dim 256, ops/flash_bwd.py::f32_work; into
// dq_acc, q_items x batch x hq slots of a tile's rows x head_dim f32), 2 the
// dk/dv kernel (kv_table: the
// kv-major work list of kv_items items; into dk_acc and dv_acc, kv_items x
// batch x hq slots each), 4 the post (dq, dk, dv from the slots); every
// slot is written; delta is an input, rowsum(dout * out). q_seg and kv_seg
// are both null or both set; window 0 is none. head_dim: bf16 any multiple
// of 8 up to 512, read and written at its true width by the instance
// flash_width(head_dim, narrow) picks (hopper.cuh; dq_acc, the counters and
// the slots at that instance's tile columns, 64, 128, 256 or 512, and q
// tiles, 32 rows at 512); f32 64, 128 or 256. The caller has checked shapes, contiguity and 16-byte
// alignment.
extern "C" int tfa_flash_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* qs, void* lse2, void* delta,
    const void* q_seg, const void* kv_seg, const void* kv_table,
    const void* q_table, void* dq_acc, void* dk_acc, void* dv_acc,
    void* dq_turn, void* dq, void* dk, void* dv, int batch, int hq, int hkv,
    int q_len, int kv_len, int head_dim, int causal, int window,
    int kv_items, int q_items, float scale_log2, float sm_scale, int dtype,
    int narrow, int stages, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || q_len <= 0 ||
      kv_len <= 0 || (q_seg == nullptr) != (kv_seg == nullptr) ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qseg = static_cast<const int*>(q_seg);
  const int* kvseg = static_cast<const int*>(kv_seg);
  if (dtype == 0) {
    const Bf16Args a{q, k, v, out, dout, static_cast<const float*>(lse), qs,
                     static_cast<float*>(lse2), static_cast<float*>(delta),
                     qseg, kvseg, static_cast<const int*>(kv_table),
                     static_cast<float*>(dq_acc), static_cast<float*>(dk_acc),
                     static_cast<float*>(dv_acc), static_cast<int*>(dq_turn),
                     dq, dk, dv, batch, hq, hkv,
                     q_len, kv_len, head_dim, causal, window, scale_log2,
                     sm_scale};
    switch (flash_width(head_dim, narrow)) {
      case 64: return (int)launch_bf16<64>(a, stages, s);
      case 80: return (int)launch_bf16<80>(a, stages, s);
      case 96: return (int)launch_bf16<96>(a, stages, s);
      case 128: return (int)launch_bf16<128>(a, stages, s);
      case 256: return (int)launch_bf16<256>(a, stages, s);
      case 512: return (int)launch_bf16<512>(a, stages, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    const F32Args a{static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    qseg, kvseg, static_cast<const int*>(kv_table),
                    static_cast<const int*>(q_table), kv_items, q_items,
                    static_cast<float*>(dq_acc), static_cast<float*>(dk_acc),
                    static_cast<float*>(dv_acc), static_cast<float*>(dq),
                    static_cast<float*>(dk), static_cast<float*>(dv), batch,
                    hq, hkv, q_len, kv_len, causal, window, scale_log2,
                    sm_scale};
    switch (head_dim) {
      case 64: return (int)launch_f32<64>(a, stages, s);
      case 128: return (int)launch_f32<128>(a, stages, s);
      case 256: return (int)launch_f32<256>(a, stages, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of a bf16 main block at the tiles' head_dim 64,
// 128, 256 or 512; -1 for any other. ops/flash_bwd.py holds ops/configs.py::
// bwd_smem_bytes to it when it loads this library.
extern "C" int tfa_flash_bwd_bf16_smem(int head_dim) {
  if (head_dim == 512) return Smem512::ALLOC;
  if (head_dim == 256) return WideSmem<256>::ALLOC;
  if (head_dim == 128) return Smem<128>::ALLOC;
  if (head_dim == 64) return Smem<64>::ALLOC;
  return -1;
}

// The dynamic shared memory of an f32 block (both kernels) at head_dim 64,
// 128 or 256; -1 for any other. ops/flash_bwd.py holds ops/configs.py::
// bwd_f32_smem_bytes to it when it loads this library.
extern "C" int tfa_flash_bwd_f32_smem(int head_dim) {
  if (head_dim == 256) return F32Smem<256>::BYTES;
  if (head_dim == 128) return F32Smem<128>::BYTES;
  if (head_dim == 64) return F32Smem<64>::BYTES;
  return -1;
}
