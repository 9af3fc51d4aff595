// FlashAttention-1 forward for Hopper (sm_90a): the FA1 loop order.
//
// Replaces tiny_flash_attention_tpu/ops/flash_v1.py::flash_attention_v1
// (_v1_kernel), the teaching kernel beside the FA2 forward (flash_fwd.cu): it
// exists to make the gap between the two loop orders visible, so it keeps
// FA1's order. KV tiles are the OUTER loop and q tiles the inner one; each q
// tile's running state (m, l and the f32 accumulator) lives in a global
// scratch and is reloaded and stored back on every KV step, like the
// reference CUDA v1's gMax/gDenom (flash_v1.py:73-76), where the FA2 kernel
// keeps one q tile's state in registers for its whole KV sweep.
//
// Contract: q, k, v (B * H, S, D) contiguous, no GQA (as in JAX); causal rows
// sit at position row + Skv - Sq (the decode offset); KV padding is masked.
// Returns out like q and a natural-log LSE (B * H, Sq) in f32. Rounding
// points are JAX's: q scaled by sm_scale * log2(e) in q's dtype, the softmax
// in the log2 domain in f32, p cast to v's dtype before the PV product, LSE
// m * ln2 + log(l). Every row that sees no column gets out 0 and the LSE
// sentinel (mask value) * ln2, in a q tile that some KV tile reaches or not
// (JAX leaves -inf in a tile no KV tile reaches).
//
// What bounds it: the tensor-core FLOPs of the visible pairs, as FA2, plus
// what FA1 adds on every (KV tile, q tile) step: the q tile reloaded and
// rescaled, and the tile's f32 state read and written back (128 x (D + 8)
// floats each way, 69.6 KB at head_dim 128), hundreds of MB per call, mostly
// served from L2.
//
// The bf16 design, on wgmma and TMA (csrc/hopper.cuh), B1's structure with
// FA1's loop order kept:
//   * one block of three warpgroups takes Q_TILES 128-row q tiles of one
//     head from a host-built schedule (ops/flash_v1.py::v1_schedule: tiles
//     dealt longest first in snake order, so the causal work of the blocks
//     evens out); warpgroups 0 and 1 consume, 64 q rows each; warpgroup 2
//     produces (setmaxnreg, as in flash_fwd.cu).
//   * one elected producer thread walks the same loops as the consumers: for
//     each KV tile it TMA-loads K and V into a ring of STAGES stages (full
//     barriers for K and V apart, so S starts before V lands; an empty
//     barrier on which the 256 consumer threads arrive at the end of the KV
//     step), then each of the block's q tiles that sees the KV tile into a
//     ring of as many stages of its own (released once S has read it). So
//     KV tile j + 1 lands while tile j's q tiles are walked.
//   * a consumer step (KV tile j, q tile t): the stores of the previous
//     step's state, then the loads of this step's state (j > 0), issued
//     before the S product so that their latency hides behind the q fold and
//     the product; the fold of bf16(sm_scale * log2 e) into its 64 rows of
//     the landed q tile in shared memory (reloaded, so folded again on every
//     step); S = Q K^T as SS wgmma m64n128k16; the mask where the tile
//     straddles the diagonal or the kv edge; the online softmax from the
//     reloaded (m, l) in the log2 domain; O rescaled; P rounded to bf16 as
//     the A operand of the RS wgmma O += P V. At t's last visible KV tile it
//     writes out and the LSE instead of the state. The kernel owns the
//     scratch layout: each thread's accumulator registers in wgmma fragment
//     order (float4 i of thread x at [i * 128 + x]) and its (m, m', l, l')
//     as one float4, the row sums as per-thread partials reduced over the
//     quad only at the write, so both directions are coalesced 16-byte
//     accesses of one thread's own slots (no barrier needed between them).
//     No thread waits for its stores: the next access to a slot is the
//     same thread's reload, one KV step later, in program order. FA1's
//     round trip costs issue slots and L2 traffic, not a stall.
//   * head dims in (128, 256] (the wide instance, V1Tiles<256>): 64-row kv
//     tiles, S as m64n64k16 and PV as m64n256k16 (O 128 floats a thread,
//     its state slot 33 float4s), the K/V ring in two stages and the q
//     tile in one (192 KiB; a second q stage beside them would need 256):
//     the producer loads the next step's q tile once this step's S has
//     read the stage, while its softmax and PV run.
//
// The f32 instance runs on the CUDA cores (never TF32) with FA1's order and
// round trip kept; its design is at the f32 path below.
//
// Head dims in (128, 256] run the wide instances (the wrapper pads them to
// 256): at the tiles above a block would need 394,320 bytes of shared
// memory in bf16 and 427,104 in f32, so they take smaller tiles (V1Tiles,
// V1F32Tiles; designs at each path).
//
// Tile sizes, stages and q tiles a block come from
// tiny_flash_attention_tpu_torch/ops/configs.py as -D defines; the
// shared-memory layouts are V1Smem and V1F32Smem (tfa_flash_v1_smem exports
// their sizes).

#include <type_traits>

#include "hopper.cuh"

#if !defined(TFA_V1_BF16_BLOCK_M) || !defined(TFA_V1_BF16_BLOCK_N) ||   \
    !defined(TFA_V1_BF16_THREADS) || !defined(TFA_V1_BF16_STAGES) ||    \
    !defined(TFA_V1_BF16_Q_TILES) || !defined(TFA_V1_F32_BLOCK_M) ||    \
    !defined(TFA_V1_F32_BLOCK_N) || !defined(TFA_V1_F32_THREADS) ||     \
    !defined(TFA_V1_F32_Q_TILES) || !defined(TFA_V1_BF16_WIDE_BLOCK_M) || \
    !defined(TFA_V1_BF16_WIDE_BLOCK_N) ||                               \
    !defined(TFA_V1_BF16_WIDE_THREADS) ||                               \
    !defined(TFA_V1_BF16_WIDE_Q_STAGES) ||                              \
    !defined(TFA_V1_BF16_WIDE_KV_STAGES) ||                             \
    !defined(TFA_V1_F32_WIDE_BLOCK_M) ||                                \
    !defined(TFA_V1_F32_WIDE_BLOCK_N) || !defined(TFA_V1_F32_WIDE_THREADS)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- bf16 path

constexpr int BM = TFA_V1_BF16_BLOCK_M;        // q rows per tile
constexpr int THREADS = TFA_V1_BF16_THREADS;   // 2 consumers + 1 producer
constexpr int Q_TILES = TFA_V1_BF16_Q_TILES;   // q tiles a block
static_assert(BM == 128 && TFA_V1_BF16_BLOCK_N == 128 && THREADS == 384 &&
                  TFA_V1_BF16_WIDE_BLOCK_M == BM &&
                  TFA_V1_BF16_WIDE_BLOCK_N == 64 &&
                  TFA_V1_BF16_WIDE_THREADS == THREADS,
              "two consumer warpgroups of 64 q rows and a producer "
              "warpgroup over 128-row kv tiles (64-row at the wide "
              "instance)");
constexpr int CONSUMERS = 256;
// 40 * 128 + 232 * 256 = 64512 of the SM's 65536 registers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// The kv tile and the rings of the instance over tiles of D columns: up to
// 128 columns, 128-row kv tiles and TFA_V1_BF16_STAGES stages of q and of
// K/V; at 256 (the wide instance) a 128-row q tile is 64 KiB and a 128-row
// K+V stage 128 KiB, so its kv tiles are 64 rows (S 32 f32 registers a
// consumer thread beside O's 128, as B1's wide instance), in rings of
// TFA_V1_BF16_WIDE_Q_STAGES q and TFA_V1_BF16_WIDE_KV_STAGES K/V stages.
template <int D>
struct V1Tiles {
  static constexpr bool WIDE = D > 128;
  static constexpr int BN = WIDE ? TFA_V1_BF16_WIDE_BLOCK_N
                                 : TFA_V1_BF16_BLOCK_N;
  static constexpr int Q_STAGES = WIDE ? TFA_V1_BF16_WIDE_Q_STAGES
                                       : TFA_V1_BF16_STAGES;
  static constexpr int KV_STAGES = WIDE ? TFA_V1_BF16_WIDE_KV_STAGES
                                        : TFA_V1_BF16_STAGES;
};

// Shared memory of one block, in bytes from a 1024-aligned base: the q
// ring (QS stages) and the K/V ring (KS stages).
template <int D>
struct V1Smem {
  static constexpr int BN = V1Tiles<D>::BN;      // kv rows per tile
  static constexpr int QS = V1Tiles<D>::Q_STAGES;
  static constexpr int KS = V1Tiles<D>::KV_STAGES;
  static constexpr int QT = BM * D * 2;          // one q tile
  static constexpr int KV = BN * D * 2;          // one K or V tile
  static constexpr int Q = 0;                    // [QS] q tiles
  static constexpr int K = QS * QT;              // [KS] K tiles
  static constexpr int V = K + KS * KV;          // [KS] V tiles
  // q_full, q_empty, [QS] each; k_full, v_full, kv_empty, [KS] each
  static constexpr int BAR = V + KS * KV;
  static constexpr int TOTAL = BAR + (2 * QS + 3 * KS) * 8;
  static constexpr int ALLOC = TOTAL + 1024;     // room to align the base
  static_assert(ALLOC <= 232448, "a block has 227 KB of shared memory");
};

// float4s of one warpgroup's state slot: D / 8 of the accumulator, then
// (m, m', l, l'), each times its 128 threads
template <int D>
__host__ __device__ constexpr int state_f4() {
  return (D / 8 + 1) * 128;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_v1_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          float4* state, const int* __restrict__ schedule,
                          int q_len, int kv_len, int causal,
                          float scale_log2) {
  using S = V1Smem<D>;
  constexpr int BN = S::BN;                      // kv rows per tile
  constexpr int QS = S::QS, KS = S::KS;          // q and K/V ring stages
  constexpr int BOXES = D / 64;                  // 64-wide column blocks
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* q_empty = q_full + QS;
  uint64_t* k_full = q_empty + QS;
  uint64_t* v_full = k_full + KS;
  uint64_t* kv_empty = v_full + KS;

  const int tid = threadIdx.x, wg = tid / 128;
  const int bh = blockIdx.y;
  const int n_q = (q_len + BM - 1) / BM;
  const int offset = kv_len - q_len;
  // this block's q tiles (-1: none) and the KV tiles each sees, [0, hi)
  int tiles[Q_TILES], hi[Q_TILES];
  int kv_end = 0;
#pragma unroll
  for (int i = 0; i < Q_TILES; ++i) {
    tiles[i] = schedule[blockIdx.x * Q_TILES + i];
    hi[i] = tiles[i] < 0 ? 0
                         : kv_tiles(tiles[i] * BM, BM, q_len, kv_len, causal,
                                    BN);
    kv_end = max(kv_end, hi[i]);
  }

  if (tid == 0) {
    for (int st = 0; st < (QS > KS ? QS : KS); ++st) {
      if (st < QS) {
        mbar_init(&q_full[st], 1);
        mbar_init(&q_empty[st], CONSUMERS);
      }
      if (st < KS) {
        mbar_init(&k_full[st], 1);
        mbar_init(&v_full[st], 1);
        mbar_init(&kv_empty[st], CONSUMERS);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_dealloc<PRODUCER_REGS>();
    if (tid % 128 == 0) {
      int qc = 0;                                // q tiles loaded so far
      for (int j = 0; j < kv_end; ++j) {         // the outer loop: KV tiles
        const int st = j % KS;
        if (j >= KS) mbar_wait(&kv_empty[st], (j / KS - 1) & 1);
        mbar_expect_tx(&k_full[st], S::KV);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load_3d(sm + S::K + st * S::KV + c * BN * 128, &tm_k,
                      &k_full[st], 64 * c, j * BN, bh);
        mbar_expect_tx(&v_full[st], S::KV);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          tma_load_3d(sm + S::V + st * S::KV + c * BN * 128, &tm_v,
                      &v_full[st], 64 * c, j * BN, bh);
#pragma unroll
        for (int i = 0; i < Q_TILES; ++i) {      // inner: q tiles
          if (j >= hi[i]) continue;
          const int qs = qc % QS;
          if (qc >= QS) mbar_wait(&q_empty[qs], (qc / QS - 1) & 1);
          mbar_expect_tx(&q_full[qs], S::QT);
#pragma unroll
          for (int c = 0; c < BOXES; ++c)
            tma_load_3d(sm + S::Q + qs * S::QT + c * BM * 128, &tm_q,
                        &q_full[qs], 64 * c, tiles[i] * BM, bh);
          ++qc;
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    regs_alloc<CONSUMER_REGS>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));
    bf16* og = o + (size_t)bh * q_len * D;
    float* lg = lse + (size_t)bh * q_len;
    // this warpgroup's state slot of q tile `tile`
    auto slot = [&](int tile) {
      return state + (((size_t)bh * n_q + tile) * 2 + wg) * state_f4<D>();
    };

    float oacc[D / 2];
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // per-thread partial sums
    float4* pending = nullptr;  // a state not yet stored back, and its slot

    // the state back to its slot: coalesced 16-byte stores of this thread's
    // own fragment slots, issued without waiting for them
    auto store_state = [&](float4* sl) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        sl[i * 128 + t] = make_float4(oacc[4 * i], oacc[4 * i + 1],
                                      oacc[4 * i + 2], oacc[4 * i + 3]);
      sl[(D / 8) * 128 + t] = make_float4(m_run[0], m_run[1], l_run[0],
                                          l_run[1]);
    };

    int qc = 0;
    for (int j = 0; j < kv_end; ++j) {           // the outer loop: KV tiles
      const int st = j % KS, kv0 = j * BN;
      bool first = true;                         // first q tile of this step
#pragma unroll 1
      for (int i = 0; i < Q_TILES; ++i) {        // inner: q tiles
        if (j >= hi[i]) continue;
        const int tile = tiles[i], q0 = tile * BM;
        const int qs = qc % QS;
        // FA1's round trip: the previous step's state goes back, this
        // step's comes in; both issued before the S product
        if (pending != nullptr) store_state(pending);
        pending = nullptr;
        float4* sl = slot(tile);
        if (j == 0) {
#pragma unroll
          for (int x = 0; x < D / 2; ++x) oacc[x] = 0.f;
          m_run[0] = m_run[1] = -INFINITY;
          l_run[0] = l_run[1] = 0.f;
        } else {
#pragma unroll
          for (int x = 0; x < D / 8; ++x) {
            const float4 a = sl[x * 128 + t];
            oacc[4 * x] = a.x;
            oacc[4 * x + 1] = a.y;
            oacc[4 * x + 2] = a.z;
            oacc[4 * x + 3] = a.w;
          }
          const float4 ml = sl[(D / 8) * 128 + t];
          m_run[0] = ml.x;
          m_run[1] = ml.y;
          l_run[0] = ml.z;
          l_run[1] = ml.w;
        }

        // the q tile, reloaded on every step: q * bf16(sm_scale * log2 e)
        // rounded to bf16 (the TPU kernels' fold), in place, this
        // warpgroup's 64 rows; rows past q_len are TMA's zeros
        unsigned char* qw = sm + S::Q + qs * S::QT + wg * 64 * 128;
        mbar_wait(&q_full[qs], (qc / QS) & 1);
#pragma unroll
        for (int c = 0; c < BOXES; ++c) {
          uint4* p = reinterpret_cast<uint4*>(qw + c * BM * 128);
#pragma unroll
          for (int x = t; x < 64 * 128 / 16; x += 128) {
            uint4 raw = p[x];
            bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
            for (int y = 0; y < 8; ++y)
              e[y] = __float2bfloat16_rn(__bfloat162float(e[y]) * qscale);
            p[x] = raw;
          }
        }
        fence_async_smem();  // the generic stores, before wgmma reads them
        named_bar(1 + wg, 128);

        // S = Q K^T: 64 q rows x BN kv columns
        if (first) mbar_wait(&k_full[st], (j / KS) & 1);
        const unsigned char* kt = sm + S::K + st * S::KV;
        float s[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BN, 0, 0>(
              s, smem_desc(qw + (kk / 4) * BM * 128 + (kk % 4) * 32, 16, 1024),
              smem_desc(kt + (kk / 4) * BN * 128 + (kk % 4) * 32, 16, 1024),
              kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        mbar_arrive(&q_empty[qs]);  // this thread has read the q stage
        ++qc;

        // the mask, where the warp's rows straddle the diagonal or the kv
        // edge; this thread's rows: qrow (slots 0, 1 of each 8 columns)
        // and qrow + 8 (slots 2, 3)
        const int qrow = q0 + wg * 64 + warp * 16 + lane / 4;
        const int warp_first_pos = q0 + wg * 64 + warp * 16 + offset;
        if (kv0 + BN > kv_len || (causal && kv0 + BN - 1 > warp_first_pos)) {
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = kv0 + 8 * jj + 2 * (lane % 4) + (e & 1);
              const int row = qrow + (e >> 1) * 8;
              if (col >= kv_len || (causal && col > row + offset))
                s[4 * jj + e] = kMaskValue;
            }
          }
        }
        // the online softmax from the reloaded state (log2 domain, one
        // quad of lanes per row)
        float m_new[2], keep[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m_run[r];
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj)
            mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          m_new[r] = mx;
          alpha[r] = ex2(m_run[r] - mx);
          // a row that has seen only masked columns keeps m at the mask
          // floor, where exp2(s - m) would be 1
          keep[r] = mx > 0.5f * kMaskValue ? 1.f : 0.f;
          m_run[r] = mx;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * jj + e] = ex2(s[4 * jj + e] - m_new[e >> 1]) * keep[e >> 1];
          rs[0] += s[4 * jj + 0] + s[4 * jj + 1];
          rs[1] += s[4 * jj + 2] + s[4 * jj + 3];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rs[r];
#pragma unroll
        for (int x = 0; x < D / 8; ++x) {
          oacc[4 * x + 0] *= alpha[0];
          oacc[4 * x + 1] *= alpha[0];
          oacc[4 * x + 2] *= alpha[1];
          oacc[4 * x + 3] *= alpha[1];
        }
        // O += P V, P rounded to bf16 (the TPU kernel casts p before the
        // second dot) as the A fragments, V read MN-major
        uint32_t pa[BN / 16][4];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
        if (first) mbar_wait(&v_full[st], (j / KS) & 1);
        first = false;
        const unsigned char* vt = sm + S::V + st * S::KV;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          wgmma_rs<D>(oacc, pa[kk],
                      smem_desc(vt + kk * 16 * 128, BN * 128, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(pa);

        if (j < hi[i] - 1) {
          pending = sl;  // stored at the start of the next step
        } else {  // the tile's last visible KV tile: out and the LSE
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float l = l_run[r];
            l += __shfl_xor_sync(0xffffffffu, l, 1);
            l += __shfl_xor_sync(0xffffffffu, l, 2);
            const float l_safe = (l == 0.f || l != l) ? 1.f : l;
            const int row = qrow + r * 8;
            if (row < q_len) {
#pragma unroll
              for (int x = 0; x < D / 8; ++x) {
                const int col = 8 * x + 2 * (lane % 4);
                *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * D +
                                                   col) =
                    __floats2bfloat162_rn(oacc[4 * x + 2 * r] / l_safe,
                                          oacc[4 * x + 2 * r + 1] / l_safe);
              }
              if (lane % 4 == 0) lg[row] = m_run[r] * kLn2 + logf(l_safe);
            }
          }
        }
      }
      mbar_arrive(&kv_empty[st]);  // this thread has read K and V of step j
    }
    if (pending != nullptr) store_state(pending);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, float* state, const int* schedule,
                        int n_blocks, int bh, int q_len, int kv_len,
                        int causal, float scale_log2, cudaStream_t stream) {
  using S = V1Smem<D>;
  const auto kernel = flash_v1_wgmma_kernel<D>;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(kernel, S::ALLOC, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  if (!bf16_map(&mq, q, D, q_len, bh, BM) ||
      !bf16_map(&mk, k, D, kv_len, bh, S::BN) ||
      !bf16_map(&mv, v, D, kv_len, bh, S::BN))
    return cudaErrorInvalidValue;
  const dim3 grid(n_blocks, bh);
  kernel<<<grid, THREADS, S::ALLOC, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse),
      reinterpret_cast<float4*>(state), schedule, q_len, kv_len, causal,
      scale_log2);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path
//
// Real f32 FMAs on the CUDA cores (never TF32; the f32 gate is 2e-5), FA1's
// order kept: one block of 17 warps takes F_QT 64-row q tiles of one head
// from v1_schedule (longest first, snake order) and walks the kv tiles of 64
// rows outer, its q tiles inner. A (kv tile j, q tile t) step is FA1's
// (Algorithm 1 of the FlashAttention paper): S = q_t K_j^T with q folded by
// sm_scale * log2 e in f32, the tile's own row max mt and p' = exp2(s - mt),
// lt = rowsum(p'); then the state of t (m, l and the unnormalized output)
// is reloaded from the scratch, merged (m' = max(m, mt), O = O exp2(m - m')
// + exp2(mt - m') p' V_j, the same for l) and stored back; at t's last kv
// tile, out = O / l and the LSE are written instead. The warps split a
// step's two products by role, so that each product runs on register tiles
// fed by float4 reads and the two run at once:
//   * two S groups of 128 threads take the steps in turn (even, odd); a
//     thread computes an 8 x 4 tile of S (rows 8a.., columns g + 16 i) over
//     the head dim, 12 float4 reads for 128 FMAs, then the masked, tile-
//     local softmax (row max and sum over 16 lanes), and writes p'^T and
//     (mt, lt) of its step to its group's buffer in shared memory.
//   * the PV group of 256 threads takes every step in order: a thread owns
//     an (D / 16) x 4 tile of O (8 x 4 at head_dim 128; rows, and a
//     16-byte column chunk), reloads its O and (m, l) from the scratch while
//     it computes its tile of p' V_j (3 float4 reads for 32 FMAs), merges
//     and stores them back: each thread's own slots, coalesced (float4 i of
//     thread w at [i * 256 + w]; the (m, l) of a row group by its first
//     D / 32 lanes, broadcast by shuffles), so no barrier or wait stands
//     between a store and the reload, which is the same thread's, one kv
//     step later. The S groups hold no state.
//   * a loader warp streams K tiles through a two-stage ring and each
//     step's q tile into its S group's buffer, by cp.async, each tile's
//     copies completing on an mbarrier (cp.async.mbarrier.arrive); the S
//     groups arrive on empty barriers once they have read them. The PV
//     group loads V into a two-stage ring of its own, tile j + 1 landing
//     while tile j's steps run, with one barrier among its warps a kv tile.
// So kv tile j + 1 lands while tile j's q tiles are walked, and no block
// barrier runs inside the loop: mbarriers between the roles, two P buffers
// (one per S group) between the S groups and the PV group. Tiles sit
// row-major with each row's 16-byte chunks XOR-swizzled (K, V by the row, q
// by the row's 8-row group), so the strided float4 reads are free of bank
// conflicts. Shared memory (V1F32Smem): 230,496 bytes at head_dim 128, one
// block of 17 warps an SM.
//
// Head dims in (128, 256] (the wide instance, V1F32Tiles<256>): at 64 x 64
// a block would need 427,104 bytes, so the tiles are 32 q rows and 32 kv
// rows (205,408 bytes) and the roles keep their threads with their maps
// scaled: an S thread holds 4 x 2 scores (rows 4a.., the q chunks keyed by
// the row's 4-row group), a PV thread still 8 rows x 4 columns of O (32 x
// 256 over 256 threads, as 64 x 128 at 128), so a row group spans two
// warps, and each warp keeps its own copy of the group's (m, l) in the
// state slot (a warp that read the other's would race its store).

constexpr int FTHREADS = TFA_V1_F32_THREADS;   // 2 S groups, PV, loader
constexpr int F_QT = TFA_V1_F32_Q_TILES;       // q tiles a block
static_assert(TFA_V1_F32_BLOCK_M == 64 && TFA_V1_F32_BLOCK_N == 64 &&
                  TFA_V1_F32_WIDE_BLOCK_M == 32 &&
                  TFA_V1_F32_WIDE_BLOCK_N == 32 && FTHREADS == 544 &&
                  TFA_V1_F32_WIDE_THREADS == FTHREADS && F_QT == 2,
              "two S groups of 128 threads over 64 x 64 score tiles (32 x "
              "32 at the wide instance), a PV group of 256 and a loader "
              "warp; the S groups take the steps in turn, so with two q "
              "tiles a block each takes at most one step a kv tile");
constexpr int S_THREADS = 128, PV_THREADS = 256;

// The f32 tiles at head_dim D: FM q rows and FN kv rows (64, or 32 above
// 128 columns); an S thread holds RW x CW scores (rows RW a + [0, RW),
// columns c16 + 16 [0, CW)), a PV thread RP rows x 4 columns of O.
template <int D>
struct V1F32Tiles {
  static constexpr bool WIDE = D > 128;
  static constexpr int FM = WIDE ? TFA_V1_F32_WIDE_BLOCK_M
                                 : TFA_V1_F32_BLOCK_M;
  static constexpr int FN = WIDE ? TFA_V1_F32_WIDE_BLOCK_N
                                 : TFA_V1_F32_BLOCK_N;
  static constexpr int RW = FM / 8, CW = FN / 16;
  static constexpr int RP = FM * D / (4 * PV_THREADS);
  static_assert(FM == FN && RW % 4 == 0 && RP % 4 == 0,
                "square tiles, whole float4s of rows");
};

// Shared memory of an f32 block, in floats: the K and V rings, one q tile
// and one p'^T (FN x FM) per S group, and its (mt, lt) rows; then the
// mbarriers: k_full, k_empty, q_full, q_empty, p_full, p_empty, two each.
template <int D>
struct V1F32Smem {
  static constexpr int FM = V1F32Tiles<D>::FM, FN = V1F32Tiles<D>::FN;
  static constexpr int QT = FM * D, KT = FN * D;
  static constexpr int K = 0;                    // [2][KT]
  static constexpr int V = K + 2 * KT;           // [2][KT]
  static constexpr int Q = V + 2 * KT;           // [2 groups][QT]
  static constexpr int P = Q + 2 * QT;           // [2 groups][FN][FM]
  static constexpr int R = P + 2 * FN * FM;      // [2 groups][2][FM]
  static constexpr int BAR = R + 2 * 2 * FM;
  static constexpr int BYTES = BAR * 4 + 12 * 8;
  static_assert(BYTES <= 232448, "a block has 227 KB of shared memory");
};

// Lanes of a PV row group's segment in one warp: its C4 = D / 4 threads,
// at most a warp.
template <int D>
__host__ __device__ constexpr int pv_segment() {
  return D / 4 < 32 ? D / 4 : 32;
}

// float4s of one q tile's state slot: the PV threads' accumulators, then
// the (m, l) of each segment's RP rows (ML = RP / 2 float4s a segment; 128
// floats in all at every width)
template <int D>
__host__ __device__ constexpr int f32_state_f4() {
  return V1F32Tiles<D>::FM * D / 4 +
         PV_THREADS / pv_segment<D>() * V1F32Tiles<D>::RP / 2;
}

// Float offset of element (r, c) of a row-major tile of W-wide f32 rows,
// its 16-byte chunks XOR-swizzled by key % 8 within each group of eight.
template <int W>
__device__ __forceinline__ int swf(int r, int c, int key) {
  return r * W + ((((c >> 2) ^ key) & 7) | ((c >> 2) & ~7)) * 4 + (c & 3);
}

// This thread's cp.async copies so far complete on `bar` (an arrival of its
// own: the barrier counts the copying threads).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Rows [r0, r0 + ROWS) of a row-major (n_rows, D) f32 matrix into a
// swizzled tile (chunk key: the row >> shift), `nt` threads from `i0`; rows
// past n_rows land as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void stage_f32(float* t, const float* g, int r0,
                                          int n_rows, int shift, int i0,
                                          int nt) {
  constexpr int C4 = D / 4;
  for (int x = i0; x < ROWS * C4; x += nt) {
    const int r = x / C4, c = (x % C4) * 4;
    const bool ok = r0 + r < n_rows;
    cp_async16(t + swf<D>(r, c, r >> shift),
               g + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(FTHREADS, 1)
    flash_v1_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, float4* state,
                        const int* __restrict__ schedule, int q_len,
                        int kv_len, int causal, float scale_log2) {
  using S = V1F32Smem<D>;
  constexpr int FM = S::FM, FN = S::FN;
  constexpr int RW = V1F32Tiles<D>::RW, CW = V1F32Tiles<D>::CW;
  constexpr int QSHIFT = RW == 8 ? 3 : 2;        // q chunk key: row / RW
  extern __shared__ __align__(16) float fsm[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(fsm + S::BAR);
  uint64_t* k_full = bars;
  uint64_t* k_empty = bars + 2;
  uint64_t* q_full = bars + 4;
  uint64_t* q_empty = bars + 6;
  uint64_t* p_full = bars + 8;
  uint64_t* p_empty = bars + 10;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int n_q = (q_len + FM - 1) / FM;
  const int offset = kv_len - q_len;
  // this block's q tiles (-1: none) and the kv tiles each sees, [0, hi)
  int tiles[F_QT], hi[F_QT];
  int kv_end = 0;
#pragma unroll
  for (int i = 0; i < F_QT; ++i) {
    tiles[i] = schedule[blockIdx.x * F_QT + i];
    hi[i] = tiles[i] < 0 ? 0
                         : kv_tiles(tiles[i] * FM, FM, q_len, kv_len, causal,
                                    FN);
    kv_end = max(kv_end, hi[i]);
  }

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&k_full[i], 32);
      mbar_init(&k_empty[i], 2 * S_THREADS);
      mbar_init(&q_full[i], 32);
      mbar_init(&q_empty[i], S_THREADS);
      mbar_init(&p_full[i], S_THREADS);
      mbar_init(&p_empty[i], PV_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * S_THREADS + PV_THREADS) {
    // -------------------------------------------------------------- loader
    const int lane = tid % 32;
    const float* kg = k + (size_t)bh * kv_len * D;
    const float* qg = q + (size_t)bh * q_len * D;
    int s = 0, qn[2] = {0, 0};
    for (int j = 0; j < kv_end; ++j) {           // the outer loop: kv tiles
      const int st = j & 1;
      if (j >= 2) mbar_wait(&k_empty[st], ((j >> 1) - 1) & 1);
      stage_f32<D, FN>(fsm + S::K + st * S::KT, kg, j * FN, kv_len, 0, lane,
                       32);
      cp_async_arrive(&k_full[st]);
#pragma unroll
      for (int i = 0; i < F_QT; ++i) {           // inner: q tiles
        if (j >= hi[i]) continue;
        const int g = s & 1;
        ++s;
        if (qn[g] >= 1) mbar_wait(&q_empty[g], (qn[g] - 1) & 1);
        ++qn[g];
        stage_f32<D, FM>(fsm + S::Q + g * S::QT, qg, tiles[i] * FM, q_len,
                         QSHIFT, lane, 32);
        cp_async_arrive(&q_full[g]);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else if (tid < 2 * S_THREADS) {
    // ------------------------------------------------------------ S groups
    const int g = tid / S_THREADS, u = tid % S_THREADS;
    // rows RW a + [0, RW), columns c16 + 16 i
    const int a = u / 16, c16 = u % 16;
    float* qs = fsm + S::Q + g * S::QT;
    float* pt = fsm + S::P + g * FN * FM;        // p'^T [kv][q]
    float* rows = fsm + S::R + g * 2 * FM;       // mt, lt
    int s = 0, qn = 0, pn = 0;
    for (int j = 0; j < kv_end; ++j) {
      const int st = j & 1, kv0 = j * FN;
      const float* kt = fsm + S::K + st * S::KT;
      bool had = false;
#pragma unroll 1
      for (int i = 0; i < F_QT; ++i) {
        if (j >= hi[i]) continue;
        const bool mine = (s & 1) == g;
        ++s;
        if (!mine) continue;
        had = true;
        const int q0 = tiles[i] * FM;
        // the q tile, reloaded on every step: q * (sm_scale * log2 e) in
        // f32 (the plain version's rounding), in place
        mbar_wait(&q_full[g], qn & 1);
        ++qn;
        for (int x = u; x < S::QT / 4; x += S_THREADS) {
          float4* p4 = reinterpret_cast<float4*>(qs) + x;
          float4 y = *p4;
          y.x *= scale_log2; y.y *= scale_log2;
          y.z *= scale_log2; y.w *= scale_log2;
          *p4 = y;
        }
        named_bar(1 + g, S_THREADS);
        mbar_wait(&k_full[st], (j >> 1) & 1);
        // S: rows RW a + r, columns c16 + 16 i
        float sc[RW][CW];
#pragma unroll
        for (int r = 0; r < RW; ++r)
#pragma unroll
          for (int c = 0; c < CW; ++c) sc[r][c] = 0.f;
#pragma unroll 1
        for (int d = 0; d < D; d += 4) {
          float4 kv[CW];
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            const int kr = c16 + 16 * c;
            kv[c] = *reinterpret_cast<const float4*>(kt + swf<D>(kr, d, kr));
          }
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(
                qs + swf<D>(RW * a + r, d, a));
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              sc[r][c] = fmaf(qv.x, kv[c].x, sc[r][c]);
              sc[r][c] = fmaf(qv.y, kv[c].y, sc[r][c]);
              sc[r][c] = fmaf(qv.z, kv[c].z, sc[r][c]);
              sc[r][c] = fmaf(qv.w, kv[c].w, sc[r][c]);
            }
          }
        }
        mbar_arrive(&q_empty[g]);                // q and K read
        mbar_arrive(&k_empty[st]);
        // the mask where the thread's rows straddle the diagonal or the kv
        // edge
        if (kv0 + FN > kv_len ||
            (causal && kv0 + FN - 1 > q0 + RW * a + offset)) {
#pragma unroll
          for (int r = 0; r < RW; ++r)
#pragma unroll
            for (int c = 0; c < CW; ++c) {
              const int col = kv0 + c16 + 16 * c, row = q0 + RW * a + r;
              if (col >= kv_len || (causal && col > row + offset))
                sc[r][c] = kMaskValue;
            }
        }
        // the tile's own softmax (log2 domain): row max and sum over the
        // 16 lanes of a row group; a row whose columns are all masked here
        // gives p' = 0, lt = 0 and mt at the mask value
        float mt[RW], lt[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float mx = fmaxf(sc[r][0], sc[r][1]);
          if constexpr (CW == 4) mx = fmaxf(mx, fmaxf(sc[r][2], sc[r][3]));
#pragma unroll
          for (int w = 1; w < 16; w <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float keep = mx > 0.5f * kMaskValue ? 1.f : 0.f;
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < CW; ++c) {
            sc[r][c] = exp2f(sc[r][c] - mx) * keep;
            sum += sc[r][c];
          }
#pragma unroll
          for (int w = 1; w < 16; w <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, w);
          mt[r] = mx;
          lt[r] = sum;
        }
        // p'^T and (mt, lt) into this group's buffer, once the PV group has
        // read the previous ones
        if (pn >= 1) mbar_wait(&p_empty[g], (pn - 1) & 1);
        ++pn;
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const int col = c16 + 16 * c;
#pragma unroll
          for (int h = 0; h < RW / 4; ++h)
            *reinterpret_cast<float4*>(pt + swf<FM>(col, RW * a + 4 * h,
                                                    col)) =
                make_float4(sc[4 * h][c], sc[4 * h + 1][c], sc[4 * h + 2][c],
                            sc[4 * h + 3][c]);
        }
        if (c16 == 0) {
          float4* m4 = reinterpret_cast<float4*>(rows + RW * a);
#pragma unroll
          for (int h = 0; h < RW / 4; ++h)
            m4[h] = make_float4(mt[4 * h], mt[4 * h + 1], mt[4 * h + 2],
                                mt[4 * h + 3]);
          float4* l4 = reinterpret_cast<float4*>(rows + FM + RW * a);
#pragma unroll
          for (int h = 0; h < RW / 4; ++h)
            l4[h] = make_float4(lt[4 * h], lt[4 * h + 1], lt[4 * h + 2],
                                lt[4 * h + 3]);
        }
        mbar_arrive(&p_full[g]);
      }
      if (!had) mbar_arrive(&k_empty[st]);       // no step of this kv tile
    }
  } else {
    // ------------------------------------------------------------ PV group
    constexpr int C4 = D / 4;                    // column chunks
    constexpr int RP = V1F32Tiles<D>::RP;        // rows a thread
    constexpr int ML = RP / 2;                   // float4s of (m, l) a row group
    // a row group's C4 threads are segments of GW lanes (two warps at
    // 256): lanes [0, ML) of each segment keep its (m, l) and shuffle them
    // over it
    constexpr int GW = pv_segment<D>();
    const int w = tid - 2 * S_THREADS;
    const int e = w % C4, a2 = w / C4;           // rows RP a2 + [0, RP)
    // this thread's segment and its lane there (the row group and e where
    // a group is one segment)
    const int seg = GW == C4 ? a2 : w / GW, sl_lane = GW == C4 ? e : w % GW;
    const float* vg = v + (size_t)bh * kv_len * D;
    float* og = o + (size_t)bh * q_len * D;
    float* lg = lse + (size_t)bh * q_len;
    stage_f32<D, FN>(fsm + S::V, vg, 0, kv_len, 0, w, PV_THREADS);
    cp_async_commit();
    int s = 0, pn[2] = {0, 0};
    for (int j = 0; j < kv_end; ++j) {
      // V_j landed for every PV thread, and V_{j-1} no longer read: its
      // stage takes V_{j+1}
      cp_async_wait<0>();
      named_bar(3, PV_THREADS);
      if (j + 1 < kv_end) {
        stage_f32<D, FN>(fsm + S::V + ((j + 1) & 1) * S::KT, vg,
                         (j + 1) * FN, kv_len, 0, w, PV_THREADS);
        cp_async_commit();
      }
      const float* vt = fsm + S::V + (j & 1) * S::KT;
#pragma unroll 1
      for (int i = 0; i < F_QT; ++i) {
        if (j >= hi[i]) continue;
        const int g = s & 1;
        ++s;
        float4* sl = state + ((size_t)bh * n_q + tiles[i]) * f32_state_f4<D>();
        float4* ml_slot = sl + RP * PV_THREADS + seg * ML + sl_lane;
        mbar_wait(&p_full[g], pn[g] & 1);
        ++pn[g];
        const float* pt = fsm + S::P + g * FN * FM;
        const float* rows = fsm + S::R + g * 2 * FM;
        // p' V_j: rows RP a2 + r, columns 4e + [0, 4)
        float pv[RP][4];
#pragma unroll
        for (int r = 0; r < RP; ++r)
          pv[r][0] = pv[r][1] = pv[r][2] = pv[r][3] = 0.f;
#pragma unroll 4
        for (int x = 0; x < FN; ++x) {
          float pr[RP];
#pragma unroll
          for (int h = 0; h < RP / 4; ++h) {
            const float4 p4 = *reinterpret_cast<const float4*>(
                pt + swf<FM>(x, RP * a2 + 4 * h, x));
            pr[4 * h] = p4.x; pr[4 * h + 1] = p4.y;
            pr[4 * h + 2] = p4.z; pr[4 * h + 3] = p4.w;
          }
          const float4 v4 =
              *reinterpret_cast<const float4*>(vt + swf<D>(x, 4 * e, x));
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            pv[r][0] = fmaf(pr[r], v4.x, pv[r][0]);
            pv[r][1] = fmaf(pr[r], v4.y, pv[r][1]);
            pv[r][2] = fmaf(pr[r], v4.z, pv[r][2]);
            pv[r][3] = fmaf(pr[r], v4.w, pv[r][3]);
          }
        }
        float mt[RP], lt[RP];
#pragma unroll
        for (int h = 0; h < RP / 4; ++h) {
          const float4 m4 =
              *reinterpret_cast<const float4*>(rows + RP * a2 + 4 * h);
          const float4 l4 =
              *reinterpret_cast<const float4*>(rows + FM + RP * a2 + 4 * h);
          mt[4 * h] = m4.x; mt[4 * h + 1] = m4.y;
          mt[4 * h + 2] = m4.z; mt[4 * h + 3] = m4.w;
          lt[4 * h] = l4.x; lt[4 * h + 1] = l4.y;
          lt[4 * h + 2] = l4.z; lt[4 * h + 3] = l4.w;
        }
        mbar_arrive(&p_empty[g]);                // p' and (mt, lt) read
        // FA1's round trip: the tile's state comes back from the scratch
        // (after the product, whose registers it would otherwise hold; the
        // S groups' warps cover its latency)
        float acc[RP][4];
        float4 ml = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j > 0) {
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float4 x = sl[r * PV_THREADS + w];
            acc[r][0] = x.x; acc[r][1] = x.y; acc[r][2] = x.z; acc[r][3] = x.w;
          }
          if (sl_lane < ML) ml = *ml_slot;
        } else {
#pragma unroll
          for (int r = 0; r < RP; ++r)
            acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
        }
        // the merge with the reloaded state: lanes [0, RP / 4) of the
        // segment hold m, the next RP / 4 l, broadcast by shuffles
        float m_new[RP], l_new[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          const float comp[4] = {ml.x, ml.y, ml.z, ml.w};
          float m_prev = __shfl_sync(0xffffffffu, comp[r % 4], r / 4, GW);
          float l_prev =
              __shfl_sync(0xffffffffu, comp[r % 4], RP / 4 + r / 4, GW);
          if (j == 0) {
            m_prev = -INFINITY;
            l_prev = 0.f;
          }
          m_new[r] = fmaxf(m_prev, mt[r]);
          const float alpha = exp2f(m_prev - m_new[r]);
          const float beta = exp2f(mt[r] - m_new[r]);
          l_new[r] = alpha * l_prev + beta * lt[r];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(acc[r][c], alpha, pv[r][c] * beta);
        }
        if (j < hi[i] - 1) {
          // the state back to its slots, without waiting for the stores
#pragma unroll
          for (int r = 0; r < RP; ++r)
            sl[r * PV_THREADS + w] =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
#pragma unroll
          for (int f = 0; f < ML; ++f) {
            if (sl_lane != f) continue;
            const float* src = f < RP / 4 ? m_new : l_new;
            const int h = f % (RP / 4);
            *ml_slot = make_float4(src[4 * h], src[4 * h + 1], src[4 * h + 2],
                                   src[4 * h + 3]);
          }
        } else {  // the tile's last visible kv tile: out and the LSE
          const int q0 = tiles[i] * FM;
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const int row = q0 + RP * a2 + r;
            const float l = l_new[r];
            const float l_safe = (l == 0.f || l != l) ? 1.f : l;
            if (row < q_len) {
              *reinterpret_cast<float4*>(og + (size_t)row * D + 4 * e) =
                  make_float4(acc[r][0] / l_safe, acc[r][1] / l_safe,
                              acc[r][2] / l_safe, acc[r][3] / l_safe);
              if (e == r) lg[row] = m_new[r] * kLn2 + logf(l_safe);
            }
          }
        }
      }
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, float* state, const int* schedule,
                       int n_blocks, int bh, int q_len, int kv_len,
                       int causal, float scale_log2, cudaStream_t stream) {
  const int smem = V1F32Smem<D>::BYTES;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(flash_v1_f32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, bh);
  flash_v1_f32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), reinterpret_cast<float4*>(state), schedule,
      q_len, kv_len, causal, scale_log2);
  return cudaGetLastError();
}

// One launch of the instance for dtype at head_dim D, after checking that
// the schedule covers every q tile and the scratch holds every state slot.
template <int D>
cudaError_t launch_v1(const void* q, const void* k, const void* v, void* o,
                      void* lse, float* state, const int* schedule,
                      int n_blocks, long long state_floats, int bh,
                      int q_len, int kv_len, int causal, float scale_log2,
                      int dtype, cudaStream_t s) {
  const int m = dtype == 0 ? BM : V1F32Tiles<D>::FM;
  const long long n_q = (q_len + m - 1) / m;
  const long long slot_floats =
      4LL * (dtype == 0 ? 2 * state_f4<D>() : f32_state_f4<D>());
  if ((long long)n_blocks * (dtype == 0 ? Q_TILES : F_QT) < n_q ||
      state_floats < (long long)bh * n_q * slot_floats)
    return cudaErrorInvalidValue;
  return dtype == 0 ? launch_bf16<D>(q, k, v, o, lse, state, schedule,
                                     n_blocks, bh, q_len, kv_len, causal,
                                     scale_log2, s)
                    : launch_f32<D>(q, k, v, o, lse, state, schedule,
                                    n_blocks, bh, q_len, kv_len, causal,
                                    scale_log2, s);
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. bh = batch *
// heads; dtype: 0 bf16, 1 f32; head_dim: 64, 128 or 256. `state` holds
// `state_floats` f32 of scratch that needs no initial values: the slots of
// every (bh, q tile), bf16 128 * (head_dim + 8) floats a 128-row tile, f32
// FM * head_dim + 128 an FM-row tile (64 rows, 32 at 256;
// ops/flash_v1.py::v1_state_floats). `schedule` holds n_blocks x the
// dtype's q tiles a block (-1: none), every q tile of the instance's
// block_m once (ops/flash_v1.py::v1_schedule). The caller has checked
// shapes, contiguity and 16-byte alignment; a bf16 launch whose tensor maps
// cannot be encoded returns cudaErrorInvalidValue.
extern "C" int tfa_flash_v1(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* state,
                            const void* schedule, int n_blocks,
                            long long state_floats, int bh, int q_len,
                            int kv_len, int head_dim, int causal,
                            float scale_log2, int dtype, void* stream) {
  if (bh <= 0 || q_len <= 0 || kv_len <= 0 || schedule == nullptr ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const auto launch = [&](auto width) {
    return (int)launch_v1<decltype(width)::value>(
        q, k, v, o, lse, static_cast<float*>(state),
        static_cast<const int*>(schedule), n_blocks, state_floats, bh, q_len,
        kv_len, causal, scale_log2, dtype, static_cast<cudaStream_t>(stream));
  };
  switch (head_dim) {
    case 64: return launch(std::integral_constant<int, 64>());
    case 128: return launch(std::integral_constant<int, 128>());
    case 256: return launch(std::integral_constant<int, 256>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory one block of the instance for dtype (0 bf16,
// 1 f32) and head_dim (64, 128 or 256) takes; -1 for any other.
// ops/flash_v1.py holds ops/configs.py::v1_smem_bytes to it when it loads
// this library.
extern "C" int tfa_flash_v1_smem(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 256) return V1Smem<256>::ALLOC;
  if (dtype == 0 && head_dim == 128) return V1Smem<128>::ALLOC;
  if (dtype == 0 && head_dim == 64) return V1Smem<64>::ALLOC;
  if (dtype == 1 && head_dim == 256) return V1F32Smem<256>::BYTES;
  if (dtype == 1 && head_dim == 128) return V1F32Smem<128>::BYTES;
  if (dtype == 1 && head_dim == 64) return V1F32Smem<64>::BYTES;
  return -1;
}
