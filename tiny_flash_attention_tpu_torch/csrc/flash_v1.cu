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
//
// The f32 instance keeps its CUDA-core body (16 x 16 threads over 64 x 64
// tiles, never TF32), FLASH_V1_F32_Q_TILES q tiles of one head a block,
// interleaved.
//
// Tile sizes, stages and q tiles a block come from
// tiny_flash_attention_tpu_torch/ops/configs.py as -D defines; the bf16
// shared-memory layout is V1Smem (tfa_flash_v1_smem exports both sizes).

#include "hopper.cuh"

#if !defined(TFA_V1_BF16_BLOCK_M) || !defined(TFA_V1_BF16_BLOCK_N) ||   \
    !defined(TFA_V1_BF16_THREADS) || !defined(TFA_V1_BF16_STAGES) ||    \
    !defined(TFA_V1_BF16_Q_TILES) || !defined(TFA_V1_F32_BLOCK_M) ||    \
    !defined(TFA_V1_F32_BLOCK_N) || !defined(TFA_V1_F32_THREADS) ||     \
    !defined(TFA_V1_F32_Q_TILES)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- bf16 path

constexpr int BM = TFA_V1_BF16_BLOCK_M;        // q rows per tile
constexpr int BN = TFA_V1_BF16_BLOCK_N;        // kv rows per tile
constexpr int THREADS = TFA_V1_BF16_THREADS;   // 2 consumers + 1 producer
constexpr int Q_TILES = TFA_V1_BF16_Q_TILES;   // q tiles a block
static_assert(BM == 128 && BN == 128 && THREADS == 384,
              "two consumer warpgroups of 64 q rows and a producer "
              "warpgroup over 128-row kv tiles");
constexpr int CONSUMERS = 256;
// 40 * 128 + 232 * 256 = 64512 of the SM's 65536 registers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// Shared memory of one block, in bytes from a 1024-aligned base.
// The q ring and the K/V ring have STAGES stages each.
template <int D>
struct V1Smem {
  static constexpr int STAGES = TFA_V1_BF16_STAGES;
  static constexpr int QT = BM * D * 2;          // one q tile
  static constexpr int KV = BN * D * 2;          // one K or V tile
  static constexpr int Q = 0;                    // [STAGES] q tiles
  static constexpr int K = STAGES * QT;          // [STAGES] K tiles
  static constexpr int V = K + STAGES * KV;      // [STAGES] V tiles
  // q_full, q_empty, k_full, v_full, kv_empty, [STAGES] each
  static constexpr int BAR = V + STAGES * KV;
  static constexpr int TOTAL = BAR + 5 * STAGES * 8;
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
  constexpr int STAGES = S::STAGES;
  constexpr int BOXES = D / 64;                  // 64-wide column blocks
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* q_empty = q_full + STAGES;
  uint64_t* k_full = q_empty + STAGES;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

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
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&q_empty[st], CONSUMERS);
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&kv_empty[st], CONSUMERS);
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
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(&kv_empty[st], (j / STAGES - 1) & 1);
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
          const int qs = qc % STAGES;
          if (qc >= STAGES)
            mbar_wait(&q_empty[qs], (qc / STAGES - 1) & 1);
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
      const int st = j % STAGES, kv0 = j * BN;
      bool first = true;                         // first q tile of this step
#pragma unroll 1
      for (int i = 0; i < Q_TILES; ++i) {        // inner: q tiles
        if (j >= hi[i]) continue;
        const int tile = tiles[i], q0 = tile * BM;
        const int qs = qc % STAGES;
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
        mbar_wait(&q_full[qs], (qc / STAGES) & 1);
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

        // S = Q K^T: 64 q rows x 128 kv columns
        if (first) mbar_wait(&k_full[st], (j / STAGES) & 1);
        const unsigned char* kt = sm + S::K + st * S::KV;
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n128<0, 0>(
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
        if (first) mbar_wait(&v_full[st], (j / STAGES) & 1);
        first = false;
        const unsigned char* vt = sm + S::V + st * S::KV;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
          const uint64_t db = smem_desc(vt + kk * 16 * 128, BN * 128, 1024);
          if constexpr (D == 128) wgmma_rs_n128(oacc, pa[kk], db);
          else wgmma_rs_n64(oacc, pa[kk], db);
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
      !bf16_map(&mk, k, D, kv_len, bh, BN) ||
      !bf16_map(&mv, v, D, kv_len, bh, BN))
    return cudaErrorInvalidValue;
  const dim3 grid(n_blocks, bh);
  kernel<<<grid, THREADS, S::ALLOC, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse),
      reinterpret_cast<float4*>(state), schedule, q_len, kv_len, causal,
      scale_log2);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path

// The running state of every q row of every head, in global memory: rows
// padded to whole q tiles.
struct V1State {
  float* m;    // (B * H, rows) running max (log2 domain)
  float* l;    // (B * H, rows) running sum
  float* acc;  // (B * H, rows, D) unnormalized output
  int rows;
};

constexpr int FM = TFA_V1_F32_BLOCK_M;
constexpr int FN = TFA_V1_F32_BLOCK_N;
constexpr int FTHREADS = TFA_V1_F32_THREADS;
// thread t owns rows (t / 16) * 4 + [0, 4) and columns t % 16 + 16 * [0, n)
static_assert(FM == 64 && FN == 64 && FTHREADS == 256,
              "the f32 thread map is 16 x 16 threads over a 64 x 64 tile");

template <int D>
__global__ void __launch_bounds__(FTHREADS)
    flash_v1_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, V1State st, int q_len,
                        int kv_len, int causal, float scale_log2) {
  constexpr int PS = FN + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [D][FM], q^T, scaled
  float* kt = qt + D * FM;                         // [D][FN], k^T
  float* vs = kt + D * FN;                         // [FN][D]
  float* ps = vs + FN * D;                         // [FM][PS]

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const int bh = blockIdx.y;
  const int offset = kv_len - q_len;
  const int n_q = (q_len + FM - 1) / FM;
  const float* qg = q + (size_t)bh * q_len * D;
  const float* kg = k + (size_t)bh * kv_len * D;
  const float* vg = v + (size_t)bh * kv_len * D;
  float* og = o + (size_t)bh * q_len * D;
  float* lg = lse + (size_t)bh * q_len;
  float* mg = st.m + (size_t)bh * st.rows;
  float* sg = st.l + (size_t)bh * st.rows;
  float* ag = st.acc + (size_t)bh * st.rows * D;

  int kv_end = 0;
  for (int t = blockIdx.x; t < n_q; t += gridDim.x)
    kv_end = max(kv_end, kv_tiles(t * FM, FM, q_len, kv_len, causal, FN));

  for (int j = 0; j < kv_end; ++j) {  // the outer loop: KV tiles
    const int kv0 = j * FN;
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int c = tid; c < FN * D / 4; c += FTHREADS) {
      const int r = c % FN, col = (c / FN) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kv0 + r < kv_len) {
        kx = *reinterpret_cast<const float4*>(kg + (size_t)(kv0 + r) * D + col);
        vx = *reinterpret_cast<const float4*>(vg + (size_t)(kv0 + r) * D + col);
      }
      kt[(col + 0) * FN + r] = kx.x;
      kt[(col + 1) * FN + r] = kx.y;
      kt[(col + 2) * FN + r] = kx.z;
      kt[(col + 3) * FN + r] = kx.w;
      *reinterpret_cast<float4*>(vs + r * D + col) = vx;
    }

    for (int t = blockIdx.x; t < n_q; t += gridDim.x) {  // inner: q tiles
      const int q0 = t * FM;
      const int hi = kv_tiles(q0, FM, q_len, kv_len, causal, FN);
      if (j >= hi) continue;
      __syncthreads();  // the previous q tile's qt and ps are no longer read
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
      __syncthreads();

      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < D; ++kk) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qt + kk * FM + rg * 4);
        const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kt[kk * FN + cg + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][c] = fmaf(qr[i], kv, s[i][c]);
        }
      }
      if (kv0 + FN > kv_len || (causal && kv0 + FN - 1 > q0 + offset)) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = kv0 + cg + 16 * c, row = q0 + rg * 4 + i;
            if (col >= kv_len || (causal && col > row + offset))
              s[i][c] = kMaskValue;
          }
      }

      float acc[4][D / 16];
      float m_run[4], l_run[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rg * 4 + i;
        // the tile's state: initial at the first KV tile, else reloaded
        const float m_prev = j == 0 ? -INFINITY : mg[row];
        const float l_prev = j == 0 ? 0.f : sg[row];
        float mx = m_prev;
#pragma unroll
        for (int c = 0; c < 4; ++c) mx = fmaxf(mx, s[i][c]);
#pragma unroll
        for (int w = 1; w < 16; w <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        const float alpha = exp2f(m_prev - mx);
        const float keep = mx > 0.5f * kMaskValue ? 1.f : 0.f;
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = exp2f(s[i][c] - mx) * keep;
          rs += p;
          ps[(rg * 4 + i) * PS + cg + 16 * c] = p;
        }
#pragma unroll
        for (int w = 1; w < 16; w <<= 1)
          rs += __shfl_xor_sync(0xffffffffu, rs, w);
        l_run[i] = alpha * l_prev + rs;
        m_run[i] = mx;
#pragma unroll
        for (int c = 0; c < D / 16; ++c)
          acc[i][c] = j == 0 ? 0.f
                             : ag[(size_t)row * D + cg + 16 * c] * alpha;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < FN; ++kk) {
        float pr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = ps[(rg * 4 + i) * PS + kk];
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const float vv = vs[kk * D + cg + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
        }
      }

      const bool last = j == hi - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + rg * 4 + i;
        if (!last) {  // FA1's signature cost: the state goes back to memory
          if (cg == 0) {
            mg[row] = m_run[i];
            sg[row] = l_run[i];
          }
#pragma unroll
          for (int c = 0; c < D / 16; ++c)
            ag[(size_t)row * D + cg + 16 * c] = acc[i][c];
        } else if (row < q_len) {
          const float l = l_run[i];
          const float l_safe = (l == 0.f || l != l) ? 1.f : l;
#pragma unroll
          for (int c = 0; c < D / 16; ++c)
            og[(size_t)row * D + cg + 16 * c] = acc[i][c] / l_safe;
          if (cg == 0) lg[row] = m_run[i] * kLn2 + logf(l_safe);
        }
      }
    }
  }
}

template <int D>
constexpr int f32_smem_bytes() {
  return (D * FM + D * FN + FN * D + FM * (FN + 1)) * (int)sizeof(float);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, const V1State& st, int bh, int q_len,
                       int kv_len, int causal, float scale_log2,
                       cudaStream_t stream) {
  const int smem = f32_smem_bytes<D>();
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(flash_v1_f32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int n_q = (q_len + FM - 1) / FM;
  const dim3 grid((n_q + TFA_V1_F32_Q_TILES - 1) / TFA_V1_F32_Q_TILES, bh);
  flash_v1_f32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), st, q_len, kv_len, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. bh = batch *
// heads; dtype: 0 bf16, 1 f32; head_dim: 64 or 128. `state` holds
// `state_floats` f32 of scratch that needs no initial values: bf16, the
// slots of every (bh, 128-row q tile), 128 * (head_dim + 8) floats each;
// f32, m and l (bh, rows) and the accumulator (bh, rows, head_dim), rows =
// q_len rounded up to 64 (ops/flash_v1.py::v1_state_floats). bf16 takes
// `schedule`, n_blocks x Q_TILES q tiles (-1: none), every q tile once
// (ops/flash_v1.py::v1_schedule); f32 ignores it. The caller has checked
// shapes, contiguity and 16-byte alignment; a bf16 launch whose tensor maps
// cannot be encoded returns cudaErrorInvalidValue.
extern "C" int tfa_flash_v1(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* state,
                            const void* schedule, int n_blocks,
                            long long state_floats, int bh, int q_len,
                            int kv_len, int head_dim, int causal,
                            float scale_log2, int dtype, void* stream) {
  if (bh <= 0 || q_len <= 0 || kv_len <= 0 ||
      (head_dim != 64 && head_dim != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(state);
  if (dtype == 0) {
    const long long n_q = (q_len + BM - 1) / BM;
    if (schedule == nullptr || n_blocks * Q_TILES < n_q ||
        state_floats < (long long)bh * n_q * BM * (head_dim + 8))
      return (int)cudaErrorInvalidValue;
    const int* sched = static_cast<const int*>(schedule);
    return (int)(head_dim == 128
                     ? launch_bf16<128>(q, k, v, o, lse, sf, sched, n_blocks,
                                        bh, q_len, kv_len, causal,
                                        scale_log2, s)
                     : launch_bf16<64>(q, k, v, o, lse, sf, sched, n_blocks,
                                       bh, q_len, kv_len, causal, scale_log2,
                                       s));
  }
  if (dtype == 1) {
    const int rows = (q_len + FM - 1) / FM * FM;
    if (state_floats < (long long)bh * rows * (head_dim + 2))
      return (int)cudaErrorInvalidValue;
    const V1State st{sf, sf + (size_t)bh * rows, sf + (size_t)2 * bh * rows,
                     rows};
    return (int)(head_dim == 128
                     ? launch_f32<128>(q, k, v, o, lse, st, bh, q_len, kv_len,
                                       causal, scale_log2, s)
                     : launch_f32<64>(q, k, v, o, lse, st, bh, q_len, kv_len,
                                      causal, scale_log2, s));
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block of the instance for dtype (0 bf16,
// 1 f32) and head_dim (64 or 128) takes; -1 for any other.
// ops/flash_v1.py holds ops/configs.py::v1_smem_bytes to it when it loads
// this library.
extern "C" int tfa_flash_v1_smem(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 128) return V1Smem<128>::ALLOC;
  if (dtype == 0 && head_dim == 64) return V1Smem<64>::ALLOC;
  if (dtype == 1 && head_dim == 128) return f32_smem_bytes<128>();
  if (dtype == 1 && head_dim == 64) return f32_smem_bytes<64>();
  return -1;
}
