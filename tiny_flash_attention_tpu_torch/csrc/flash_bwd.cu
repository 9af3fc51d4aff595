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
// Contract: q, out, dout (B, hq, Sq, D) and k, v (B, hkv, Skv, D),
// contiguous, of one dtype; lse (B, hq, Sq) is the forward's natural-log
// LSE in f32. Causal rows sit at position row + Skv - Sq. Writes dq like q,
// and dk, dv like k, summed over the GQA group of each kv head. The masks
// are the forward's (flash_fwd.cu): the window (row at position p sees
// columns [p - window + 1, p]), segment ids (equal ids attend), the mask
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
// backward of _bwd_dq_kernel/_bwd_dkv_kernel, deterministic. flash_bwd_dkv:
// one block per (64-row kv tile, kv head, batch) walks the group's q heads
// and its q tiles; flash_bwd_dq: one block per (64-row q tile, q head,
// batch) walks its kv tiles, from a q-major table.
//
// Tile sizes come from tiny_flash_attention_tpu_torch/ops/configs.py as -D
// defines; the build refuses to compile without them.

#include "hopper.cuh"

#if !defined(TFA_BWD_BF16_BLOCK_M) || !defined(TFA_BWD_BF16_BLOCK_N) || \
    !defined(TFA_BWD_BF16_THREADS) || !defined(TFA_BWD_F32_BLOCK_M) ||   \
    !defined(TFA_BWD_F32_BLOCK_N) || !defined(TFA_BWD_F32_THREADS)
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

template <int D>
__global__ void __launch_bounds__(32 * PREP_WARPS)
    flash_bwd_prep_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ out,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          bf16* __restrict__ qs, float* __restrict__ lse2,
                          float* __restrict__ delta, int n_bh, int q_len,
                          int q_pad, float scale_log2) {
  constexpr int LANES = D / 8;                   // 16 bytes a lane
  constexpr int PER_WARP = 32 / LANES;           // rows a warp
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
  const size_t off = ((size_t)bh * q_len + r) * D + sub * 8;
  const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));
  const uint4 o4 = *reinterpret_cast<const uint4*>(out + off);
  const uint4 g4 = *reinterpret_cast<const uint4*>(dout + off);
  uint4 x4 = *reinterpret_cast<const uint4*>(q + off);
  const __nv_bfloat162* o = reinterpret_cast<const __nv_bfloat162*>(&o4);
  const __nv_bfloat162* g = reinterpret_cast<const __nv_bfloat162*>(&g4);
  __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&x4);
  float dot = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dot = fmaf(__low2float(o[i]), __low2float(g[i]), dot);
    dot = fmaf(__high2float(o[i]), __high2float(g[i]), dot);
    x[i] = __floats2bfloat162_rn(__low2float(x[i]) * qscale,
                                 __high2float(x[i]) * qscale);
  }
  *reinterpret_cast<uint4*>(qs + off) = x4;
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

template <int D, bool WINDOW, bool SEGS>
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

  float dv[D / 2], dk[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dv[i] = dk[i] = 0.f;

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
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<0, 0>(
          s, smem_desc(kw + (kk / 4) * HN * 128 + (kk % 4) * 32, 16, 1024),
          smem_desc(qss + (kk / 4) * HM * 128 + (kk % 4) * 32, 16, 1024),
          kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
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
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = smem_desc(dos + kk * 16 * 128, HM * 128, 1024);
      if constexpr (D == 128) wgmma_rs_n128(dv, pa[kk], db);
      else wgmma_rs_n64(dv, pa[kk], db);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = smem_desc(qsm + kk * 16 * 128, HM * 128, 1024);
      if constexpr (D == 128) wgmma_rs_n128(dk, da[kk], db);
      else wgmma_rs_n64(dk, da[kk], db);
    }
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
  // q head's slots (the ring and K/V are free now)
  __syncthreads();
  float4* dks = reinterpret_cast<float4*>(sm) + wg * 2 * 64 * D / 4;
  float4* dvs = dks + 64 * D / 4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dks[i * 128 + t] = make_float4(dk[4 * i], dk[4 * i + 1], dk[4 * i + 2],
                                   dk[4 * i + 3]);
    dvs[i * 128 + t] = make_float4(dv[4 * i], dv[4 * i + 1], dv[4 * i + 2],
                                   dv[4 * i + 3]);
  }
  fence_async_smem();
  named_bar(1 + wg, 128);
  if (t == 0) {
    bulk_store(dkv_slot(dk_acc) + wg * (64 * D), dks, 64 * D * 4);
    bulk_store(dkv_slot(dv_acc) + wg * (64 * D), dvs, 64 * D * 4);
    bulk_wait_read();  // the writes complete before the next launch
  }
}

// One 64-row chunk of an accumulator in fragment order (64 x cw f32,
// float4 (i, t) holding rows R, R + 8 and columns C, C + 1 of the wgmma
// accumulator layout), scaled and rounded to bf16 through shared memory,
// then written as whole 16-byte pieces of rows. `parts` chunks make a tile
// of `tile_rows` rows: the parts of a 64-row tile split its columns (dq at
// D = 128), those of a 128-row tile its rows (dk, dv). With `group` > 1 the
// chunk is the sum of `group` slots, `stride` chunks apart, in slot order
// (dk, dv: the q heads of a kv head).
template <int D, int cw>
__device__ __forceinline__ void post_chunk(const float* acc, bf16* out,
                                           long chunk, int parts,
                                           int tile_rows, int tiles,
                                           int n_rows, float scale,
                                           int group, long stride,
                                           bf16* tile) {
  constexpr int LD = D + 8;                      // bf16 per tile row
  const int t = threadIdx.x;
  const int per = parts * tiles;                 // chunks of one head
  const float4* a4 = reinterpret_cast<const float4*>(acc) +
                     ((chunk / per) * group * per + chunk % per) * cw * 16;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  float4 av[cw / 8];
#pragma unroll
  for (int i = 0; i < cw / 8; ++i) av[i] = a4[i * 128 + t];
  for (int g = 1; g < group; ++g) {
    const float4* s4 = a4 + g * stride * cw * 16;
#pragma unroll
    for (int i = 0; i < cw / 8; ++i) {
      const float4 x = s4[i * 128 + t];
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
  const int part = (int)(chunk % parts);
  const int tidx = (int)((chunk / parts) % tiles);
  const long bh = chunk / parts / tiles;
  const int row0 = tidx * tile_rows + (tile_rows == 64 ? 0 : part * 64);
  const int col0 = tile_rows == 64 ? part * 64 : 0;
  bf16* o = out + (size_t)bh * n_rows * D + col0;
  for (int x = t; x < 64 * cw / 8; x += 128) {
    const int row = x / (cw / 8), c8 = (x % (cw / 8)) * 8;
    if (row0 + row < n_rows)
      *reinterpret_cast<uint4*>(o + (size_t)(row0 + row) * D + c8) =
          *reinterpret_cast<const uint4*>(tile + row * LD + c8);
  }
}

// One block of 128 threads per 64-row chunk: dq's chunks, then dk's, then
// dv's.
template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_post_kernel(const float* __restrict__ dq_acc,
                          const float* __restrict__ dk_acc,
                          const float* __restrict__ dv_acc,
                          bf16* __restrict__ dq, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, long n_dq, long n_kv,
                          int q_len, int kv_len, int group,
                          float sm_scale) {
  __shared__ __align__(16) bf16 tile[64 * (D + 8)];
  const long g = blockIdx.x;
  const int n_qt = (q_len + HM - 1) / HM, n_kvt = (kv_len + HN - 1) / HN;
  if (g < n_dq)
    post_chunk<D, 64>(dq_acc, dq, g, D / 64, HM, n_qt, q_len, sm_scale, 1, 0,
                      tile);
  else if (g < n_dq + n_kv)
    post_chunk<D, D>(dk_acc, dk, g - n_dq, 2, HN, n_kvt, kv_len, sm_scale,
                     group, 2L * n_kvt, tile);
  else
    post_chunk<D, D>(dv_acc, dv, g - n_dq - n_kv, 2, HN, n_kvt, kv_len, 1.f,
                     group, 2L * n_kvt, tile);
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
  int batch, hq, hkv, q_len, kv_len, causal, window;
  float scale_log2, sm_scale;
};

template <int D, bool WINDOW, bool SEGS>
cudaError_t launch_main(const Bf16Args& a, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  const auto kernel = flash_bwd_main_kernel<D, WINDOW, SEGS>;
  cudaError_t err = raise_smem_limit(kernel, Smem<D>::ALLOC, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mqs, mdo, mk, mv;
  const int bhq = a.batch * a.hq, bhk = a.batch * a.hkv;
  if (!bf16_map(&mq, a.q, D, a.q_len, bhq, HM) ||
      !bf16_map(&mqs, a.qs, D, a.q_len, bhq, HM) ||
      !bf16_map(&mdo, a.dout, D, a.q_len, bhq, HM) ||
      !bf16_map(&mk, a.k, D, a.kv_len, bhk, HN) ||
      !bf16_map(&mv, a.v, D, a.kv_len, bhk, HN))
    return cudaErrorInvalidValue;
  const int n_kvt = (a.kv_len + HN - 1) / HN;
  const int q_pad = (a.q_len + HM - 1) / HM * HM;
  kernel<<<n_kvt * a.hq * a.batch, HTHREADS, Smem<D>::ALLOC, stream>>>(
      mq, mqs, mdo, mk, mv, a.lse2, a.delta, a.q_seg, a.kv_seg, a.table,
      a.dq_acc, a.dk_acc, a.dv_acc, a.dq_turn, a.batch, a.hq, a.hkv, a.q_len,
      a.kv_len, q_pad, a.causal, a.window);
  return cudaGetLastError();
}

// stages: 1 prep, 2 main, 4 post (chip_smoke.py times them one by one).
template <int D>
cudaError_t launch_bf16(const Bf16Args& a, int stages, cudaStream_t stream) {
  const int q_pad = (a.q_len + HM - 1) / HM * HM;
  const int n_bh = a.batch * a.hq;
  if (stages & 1) {
    const long rows = (long)n_bh * q_pad;
    const int per_block = PREP_WARPS * 32 / (D / 8);
    flash_bwd_prep_kernel<D><<<(unsigned)((rows + per_block - 1) / per_block),
                               32 * PREP_WARPS, 0, stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.out),
        static_cast<const bf16*>(a.dout), a.lse, static_cast<bf16*>(a.qs),
        a.lse2, a.delta, n_bh, a.q_len, q_pad, a.scale_log2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    const bool w = a.window > 0, s = a.q_seg != nullptr;
    const cudaError_t err =
        w ? (s ? launch_main<D, true, true>(a, stream)
               : launch_main<D, true, false>(a, stream))
          : (s ? launch_main<D, false, true>(a, stream)
               : launch_main<D, false, false>(a, stream));
    if (err != cudaSuccess) return err;
  }
  if (stages & 4) {
    const int n_kvt = (a.kv_len + HN - 1) / HN;
    const long n_dq = (long)n_bh * (q_pad / HM) * (D / 64);  // 64-row chunks
    const long n_kv = (long)a.batch * a.hkv * n_kvt * 2;
    flash_bwd_post_kernel<D><<<(unsigned)(n_dq + 2 * n_kv), 128, 0,
                               stream>>>(
        a.dq_acc, a.dk_acc, a.dv_acc, static_cast<bf16*>(a.dq),
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), n_dq, n_kv,
        a.q_len, a.kv_len, a.hq / a.hkv, a.sm_scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ----------------------------------------------------------------- f32 path
//
// 256 threads over a 64 x 64 score tile: thread (rg, cg) = (tid / 16,
// tid % 16) owns its rows rg * 4 + [0, 4) and columns cg + 16 * [0, 4), and
// the same rows of the D-wide accumulators at columns cg + 16 * [0, D / 16).
// Tiles sit transposed in shared memory ([D][PT]); the pad of PT keeps the
// column reads of the accumulating products to two-way bank conflicts.

constexpr int FM = TFA_BWD_F32_BLOCK_M;
constexpr int FN = TFA_BWD_F32_BLOCK_N;
constexpr int FTHREADS = TFA_BWD_F32_THREADS;
static_assert(FM == 64 && FN == 64 && FTHREADS == 256,
              "the f32 thread map is 16 x 16 threads over a 64 x 64 tile");
constexpr int PT = 68;      // row stride of a transposed [D][64] tile
constexpr int PS = FN + 1;  // row stride of the [64][64] score tile

// The LSE in the log2 domain, or +inf on rows that carry the empty-row
// sentinel (and on padding rows), so that exp2(s - lse2) is 0 there.
__device__ __forceinline__ float lse2_of(float lse) {
  const float l2 = lse * kLog2e;
  return l2 > 0.5f * kMaskValue ? l2 : INFINITY;
}

template <int D>
constexpr int f32_smem_bytes() {
  return (4 * D * PT + 64 * PS + 2 * 64) * (int)sizeof(float) +
         64 * (int)sizeof(int);
}

// rows [r0, r0 + 64) of a row-major (rows, D) matrix -> t[d * PT + r],
// times `scale`; rows at or past n_rows are 0
template <int D>
__device__ __forceinline__ void load_t(float* t, const float* g, int r0,
                                       int n_rows, float scale, int tid) {
  for (int c = tid; c < 64 * D / 4; c += FTHREADS) {
    const int r = c % 64, col = (c / 64) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows)
      x = *reinterpret_cast<const float4*>(g + (size_t)(r0 + r) * D + col);
    t[(col + 0) * PT + r] = x.x * scale;
    t[(col + 1) * PT + r] = x.y * scale;
    t[(col + 2) * PT + r] = x.z * scale;
    t[(col + 3) * PT + r] = x.w * scale;
  }
}

// 64 ids from rows [r0, r0 + 64) of one batch row (0 past n)
__device__ __forceinline__ void load_ids(int* dst, const int* ids, int r0,
                                         int n, int tid) {
  for (int r = tid; r < 64; r += FTHREADS)
    dst[r] = r0 + r < n ? ids[r0 + r] : 0;
}

// out[i][j] = sum_d a[d][rg * 4 + i] * (b[d][cg + 16 j] * bscale)
template <int D>
__device__ __forceinline__ void tile_abt(float (&out)[4][4], const float* a,
                                         const float* b, float bscale,
                                         int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int kk = 0; kk < D; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(a + kk * PT + rg * 4);
    const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bv = b[kk * PT + cg + 16 * j] * bscale;
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][j] = fmaf(ar[i], bv, out[i][j]);
    }
  }
}

// acc[i][j] += sum_c sc[(rg * 4 + i) * PS + c] * b[(cg + 16 j) * PT + c]
template <int D>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][D / 16],
                                                const float* sc,
                                                const float* b, int rg,
                                                int cg) {
#pragma unroll 4
  for (int c = 0; c < 64; ++c) {
    float sr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sr[i] = sc[(rg * 4 + i) * PS + c];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float bv = b[(cg + 16 * j) * PT + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sr[i], bv, acc[i][j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_f32(float* g, float (&acc)[4][D / 16],
                                          int r0, int n_rows, float scale,
                                          int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg * 4 + i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      g[(size_t)row * D + cg + 16 * j] = acc[i][j] * scale;
  }
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
__global__ void __launch_bounds__(FTHREADS)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const int* __restrict__ q_seg,
                             const int* __restrict__ kv_seg,
                             const int* table, float* __restrict__ dk,
                             float* __restrict__ dv, int hq, int hkv,
                             int q_len, int kv_len, int causal, int window,
                             float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kt = reinterpret_cast<float*>(smem_raw);  // [D][PT] this block's K
  float* vt = kt + D * PT;                         // [D][PT] this block's V
  float* qt = vt + D * PT;                         // [D][PT] q as stored
  float* dot = qt + D * PT;                        // [D][PT] dout
  float* ps = dot + D * PT;                        // [64][PS] P^T, then dS^T
  float* l2s = ps + 64 * PS;                       // [64] lse2 of the q tile
  float* dls = l2s + 64;                           // [64] delta of the q tile
  int* qids = reinterpret_cast<int*>(dls + 64);    // [64] q ids of the tile

  const int n_kvt = (kv_len + FN - 1) / FN;
  const Table tab(table, n_kvt);
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int jt = tab.order[blockIdx.x];
  const int kv0 = jt * FN;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int lo = tab.lo[jt];
  const int n_qt = max(0, tab.hi[jt] - lo);
  const size_t kv_base = (size_t)(b * hkv + kvh) * kv_len * D;
  const bool segs = q_seg != nullptr;
  int kid[4] = {0, 0, 0, 0};  // ids of this thread's kv rows
  if (segs) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = kv0 + rg * 4 + i;
      if (col < kv_len) kid[i] = kv_seg[(size_t)b * kv_len + col];
    }
  }

  load_t<D>(kt, k + kv_base, kv0, kv_len, 1.f, tid);
  load_t<D>(vt, v + kv_base, kv0, kv_len, 1.f, tid);

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < group * n_qt; ++it) {
    const int h = kvh * group + it / n_qt;
    const int q0 = (lo + it % n_qt) * FM;
    const size_t head = (size_t)(b * hq + h) * q_len;
    __syncthreads();  // the previous step's tiles are no longer read
    load_t<D>(qt, q + head * D, q0, q_len, 1.f, tid);
    load_t<D>(dot, dout + head * D, q0, q_len, 1.f, tid);
    for (int r = tid; r < FM; r += FTHREADS) {
      const bool valid = q0 + r < q_len;
      l2s[r] = valid ? lse2_of(lse[head + q0 + r]) : INFINITY;
      dls[r] = valid ? delta[head + q0 + r] : 0.f;
    }
    if (segs) load_ids(qids, q_seg + (size_t)b * q_len, q0, q_len, tid);
    __syncthreads();

    // S^T (kv rows x q columns) with q scaled in f32 as it is read; dP^T
    float s[4][4], dp[4][4];
    tile_abt<D>(s, kt, qt, scale_log2, rg, cg);
    tile_abt<D>(dp, vt, dot, 1.f, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = cg + 16 * j;
        float p = exp2f(s[i][j] - l2s[qc]);
        if (!visible(q0 + qc, kv0 + rg * 4 + i, q_len, kv_len, causal,
                     window, segs ? qids[qc] : 0, kid[i]))
          p = 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dls[qc]);
        ps[(rg * 4 + i) * PS + qc] = p;
      }
    }
    __syncthreads();
    tile_accumulate<D>(dva, ps, dot, rg, cg);  // dV += P^T dout
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(rg * 4 + i) * PS + cg + 16 * j] = dp[i][j];
    __syncthreads();
    tile_accumulate<D>(dka, ps, qt, rg, cg);  // dK += dS^T q
  }

  store_f32<D>(dk + kv_base, dka, kv0, kv_len, sm_scale, rg, cg);
  store_f32<D>(dv + kv_base, dva, kv0, kv_len, 1.f, rg, cg);
}

template <int D>
__global__ void __launch_bounds__(FTHREADS)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const int* __restrict__ q_seg,
                            const int* __restrict__ kv_seg, const int* table,
                            float* __restrict__ dq, int hq, int hkv,
                            int q_len, int kv_len, int causal, int window,
                            float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [D][PT] q scaled
  float* dot = qt + D * PT;                        // [D][PT] dout
  float* kt = dot + D * PT;                        // [D][PT] K tile
  float* vt = kt + D * PT;                         // [D][PT] V tile
  float* dss = vt + D * PT;                        // [64][PS] dS
  int* kids = reinterpret_cast<int*>(dss + 64 * PS + 2 * 64);  // [64]

  const int n_qt = (q_len + FM - 1) / FM;
  const Table tab(table, n_qt);
  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int qi = tab.order[blockIdx.x];
  const int q0 = qi * FM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const size_t head = (size_t)(b * hq + h) * q_len;
  const size_t kv_base = (size_t)(b * hkv + kvh) * kv_len * D;
  const int lo = tab.lo[qi], hi = tab.hi[qi];
  const bool segs = q_seg != nullptr;

  load_t<D>(qt, q + head * D, q0, q_len, scale_log2, tid);
  load_t<D>(dot, dout + head * D, q0, q_len, 1.f, tid);
  float lse2[4], dlt[4];
  int qid[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    lse2[i] = row < q_len ? lse2_of(lse[head + row]) : INFINITY;
    dlt[i] = row < q_len ? delta[head + row] : 0.f;
    if (segs && row < q_len) qid[i] = q_seg[(size_t)b * q_len + row];
  }

  float dqa[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dqa[i][j] = 0.f;

  for (int t = lo; t < hi; ++t) {
    const int kv0 = t * FN;
    __syncthreads();  // the previous tile's kt / vt / dss are no longer read
    load_t<D>(kt, k + kv_base, kv0, kv_len, 1.f, tid);
    load_t<D>(vt, v + kv_base, kv0, kv_len, 1.f, tid);
    if (segs) load_ids(kids, kv_seg + (size_t)b * kv_len, kv0, kv_len, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(s, qt, kt, 1.f, rg, cg);
    tile_abt<D>(dp, dot, vt, 1.f, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + rg * 4 + i, col = kv0 + cg + 16 * j;
        float p = exp2f(s[i][j] - lse2[i]);
        if (!visible(row, col, q_len, kv_len, causal, window, qid[i],
                     segs ? kids[cg + 16 * j] : 0))
          p = 0.f;
        dss[(rg * 4 + i) * PS + cg + 16 * j] = p * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();
    tile_accumulate<D>(dqa, dss, kt, rg, cg);  // dQ += dS K
  }

  store_f32<D>(dq + head * D, dqa, q0, q_len, sm_scale, rg, cg);
}

struct F32Args {
  const float *q, *k, *v, *dout, *lse, *delta;
  const int *q_seg, *kv_seg, *kv_table, *q_table;
  float *dq, *dk, *dv;
  int batch, hq, hkv, q_len, kv_len, causal, window;
  float scale_log2, sm_scale;
};

// stages: 1 the dq kernel, 2 the dk/dv kernel.
template <int D>
cudaError_t launch_f32(const F32Args& a, int stages, cudaStream_t stream) {
  const int smem = f32_smem_bytes<D>();
  if (stages & 1) {
    static bool smem_set[kMaxDevices] = {};
    cudaError_t err =
        raise_smem_limit(flash_bwd_dq_f32_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.q_len + FM - 1) / FM, a.hq, a.batch);
    flash_bwd_dq_f32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.q_seg, a.kv_seg, a.q_table,
        a.dq, a.hq, a.hkv, a.q_len, a.kv_len, a.causal, a.window,
        a.scale_log2, a.sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    static bool smem_set[kMaxDevices] = {};
    cudaError_t err =
        raise_smem_limit(flash_bwd_dkv_f32_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.kv_len + FN - 1) / FN, a.hkv, a.batch);
    flash_bwd_dkv_f32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.q_seg, a.kv_seg, a.kv_table,
        a.dk, a.dv, a.hq, a.hkv, a.q_len, a.kv_len, a.causal, a.window,
        a.scale_log2, a.sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Returns a cudaError_t: 0 when the kernels were launched. dtype 0 (bf16):
// `stages` 1 flash_bwd_prep (delta, lse2 and qs from q, out, dout, lse), 2
// flash_bwd_main (into dq_acc and the dq_turn counters, both zeroed by the
// caller, one counter per (batch, q head, 64-row q tile, 64 head dims),
// which the kernel leaves at 0; and
// dk_acc, dv_acc: (batch, hq, ceil(kv_len / 128), 2, 64 * head_dim) f32
// each, all written), 4 flash_bwd_post (dq, dk, dv); q_seg is padded to
// whole 64-row tiles and kv_table is the (3, ceil(kv_len / 128)) table of
// 64-row q tiles followed by its dQ chain (base, pos, chain lengths).
// dtype 1
// (f32): `stages` 1 the dq kernel (q_table: (3, ceil(q_len / 64)) of 64-row
// kv tiles), 2 the dk/dv kernel (kv_table: (3, ceil(kv_len / 64)) of 64-row
// q tiles); delta is an input, rowsum(dout * out). q_seg and kv_seg are
// both null or both set; window 0 is none. head_dim: 64 or 128. The caller
// has checked shapes, contiguity and 16-byte alignment.
extern "C" int tfa_flash_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* qs, void* lse2, void* delta,
    const void* q_seg, const void* kv_seg, const void* kv_table,
    const void* q_table, void* dq_acc, void* dk_acc, void* dv_acc,
    void* dq_turn, void* dq, void* dk, void* dv, int batch, int hq, int hkv,
    int q_len, int kv_len, int head_dim, int causal, int window,
    float scale_log2, float sm_scale, int dtype, int stages, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || q_len <= 0 ||
      kv_len <= 0 || (q_seg == nullptr) != (kv_seg == nullptr) ||
      window < 0 || (window > 0 && !causal) ||
      (head_dim != 64 && head_dim != 128))
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
                     q_len, kv_len, causal, window, scale_log2, sm_scale};
    return (int)(head_dim == 128 ? launch_bf16<128>(a, stages, s)
                                 : launch_bf16<64>(a, stages, s));
  }
  if (dtype == 1) {
    const F32Args a{static_cast<const float*>(q),
                    static_cast<const float*>(k),
                    static_cast<const float*>(v),
                    static_cast<const float*>(dout),
                    static_cast<const float*>(lse),
                    static_cast<const float*>(delta),
                    qseg, kvseg, static_cast<const int*>(kv_table),
                    static_cast<const int*>(q_table),
                    static_cast<float*>(dq), static_cast<float*>(dk),
                    static_cast<float*>(dv), batch, hq, hkv, q_len, kv_len,
                    causal, window, scale_log2, sm_scale};
    return (int)(head_dim == 128 ? launch_f32<128>(a, stages, s)
                                 : launch_f32<64>(a, stages, s));
  }
  return (int)cudaErrorInvalidValue;
}
