// Flash-attention-2 forward for Hopper (sm_90a) over K/V in q's dtype: the
// bf16 kernel on wgmma and TMA, and the entry of the unquantized instances
// (the f32 kernel is flash_fwd.cuh's).
//
// Replaces the three TPU forward kernels
//   tiny_flash_attention_tpu/ops/flash.py::_flash_fwd_impl      (_fwd_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_flash_fwd    (_tri_kernel)
//   tiny_flash_attention_tpu/ops/flash_tri.py::tri_block_fwd    (_tri_block_kernel)
// and, in its jagged mode, the row-loop forward
//   tiny_flash_attention_tpu/ops/flash_rowloop.py::flash_attention_rowloop
// for K/V in q's dtype. The contract and every mask (segment ids, tile_lo
// and tile_order from segment_starts, the window, the jagged seq_lens mode,
// the mask value and the empty-row sentinel) are those of flash_fwd.cuh;
// flash_fwd_quant.cu holds the int8/e4m3 instances.
//
// What bounds it: the tensor-core FLOPs (4 * D per visible (row, column)
// pair and q head), far above the card's operations-per-byte ridge at
// prefill shapes. The bf16 design, FA3's structure (without its persistent
// tile scheduler):
//   * one block of three warpgroups per (q tile of 128 rows, q head, batch):
//     warpgroups 0 and 1 consume, 64 q rows each; warpgroup 2 produces. The
//     producer gives registers back (setmaxnreg to PRODUCER_REGS) and the
//     consumers take them (CONSUMER_REGS): S and O are 64 f32 a thread each
//     at head_dim 128, P 32 packed bf16 pairs.
//   * one elected producer thread loads the q tile once and streams 128-row
//     K and V tiles through a ring of STAGES stages by TMA: 3-D tensor maps
//     over (D, rows, batch * heads) in the 128-byte swizzle, head_dim 128 as
//     two 64-column boxes, rows past a head's length filled with zeros (the
//     mask covers them). Each stage has a full barrier for K and its kv ids,
//     one for V (so S starts before V has landed), and an empty barrier on
//     which the 256 consumer threads arrive once they have read it. The kv
//     ids come by bulk copy where kv_len and the pointer keep the source
//     16-byte aligned, else by the producer warp's own loads.
//   * a consumer folds bf16(sm_scale * log2 e) into its 64 rows of q in
//     shared memory (generic stores, then the async-proxy fence and a
//     warpgroup barrier before wgmma reads them), then for each kv tile: S =
//     Q K^T as SS wgmma m64n128k16 over D / 16 steps; the element mask, paid
//     only by warps whose tile straddles the diagonal, the window's left edge
//     or the kv edge, or has ids; the online softmax in f32 in the log2
//     domain (the accumulator holds rows lane / 4 and + 8 of each warp's 16
//     at columns 2 * (lane % 4) of every 8, as mma.sync does, so each row's
//     max and sum reduce over a quad; exp2 on the special-function unit with
//     subnormal results flushed, as in the backward); P rounded to bf16 is,
//     packed, the A operand of the RS wgmma O += P V (V read MN-major,
//     m64n{D}k16 over 8 steps); then the stage is released. Tile j's S
//     product is issued before tile j - 1's PV product, so the softmax of
//     tile j runs while the tensor cores do that PV product (FA3's
//     intra-warpgroup overlap), and O is rescaled once it has landed. So a
//     consumer holds two stages at a time, and the ring has three.
//   * the two consumers take turns to issue their products (FA3's
//     ping-pong, two named barriers), so one's softmax runs while the
//     tensor cores do the other's products.
// Blocks run longest causal rows first (tile_order's longest pruned work
// first with segment_starts). A warpgroup whose rows all lie past q_len or
// the jagged length only keeps the ring's count and writes empty rows.
//
// Tile sizes and stages come from tiny_flash_attention_tpu_torch/ops/
// configs.py (FLASH_FWD_BF16, FLASH_FWD_BF16_STAGES) as -D defines; the
// shared-memory layout is FwdSmem (tfa_flash_fwd_smem exports its size).

#include "flash_fwd.cuh"
#include "hopper.cuh"

#if !defined(TFA_FWD_BF16_BLOCK_M) || !defined(TFA_FWD_BF16_BLOCK_N) || \
    !defined(TFA_FWD_BF16_THREADS) || !defined(TFA_FWD_BF16_STAGES)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WM = TFA_FWD_BF16_BLOCK_M;        // q rows per block
constexpr int WN = TFA_FWD_BF16_BLOCK_N;        // kv rows per tile
constexpr int WTHREADS = TFA_FWD_BF16_THREADS;  // 2 consumers + 1 producer
static_assert(WM == 128 && WN == 128 && WTHREADS == 384,
              "two consumer warpgroups of 64 q rows and a producer "
              "warpgroup over 128-row kv tiles");
constexpr int CONSUMERS = 256;  // consumer threads: arrivals on an empty slot
// 40 * 128 + 232 * 256 = 64512 of the SM's 65536 registers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// Shared memory of one block, in bytes from a 1024-aligned base.
template <int D>
struct FwdSmem {
  static constexpr int STAGES = TFA_FWD_BF16_STAGES;
  static constexpr int QT = WM * D * 2;          // the q tile
  static constexpr int KV = WN * D * 2;          // one K or V tile
  static constexpr int Q = 0;
  static constexpr int K = QT;                   // [STAGES] K tiles
  static constexpr int V = K + STAGES * KV;      // [STAGES] V tiles
  static constexpr int IDS = V + STAGES * KV;    // [STAGES][WN] kv ids
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int BAR = IDS + STAGES * WN * 4;
  static constexpr int TOTAL = BAR + (1 + 3 * STAGES) * 8;
  static constexpr int ALLOC = TOTAL + 1024;     // room to align the base
  static_assert(ALLOC <= 232448, "a block has 227 KB of shared memory");
};

template <int D, bool WINDOW, bool SEGS>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           FwdMasks mk, int hq, int hkv, int q_len,
                           int kv_len, int causal, float scale_log2,
                           int window) {
  using S = FwdSmem<D>;
  constexpr int STAGES = S::STAGES;
  constexpr int BOXES = D / 64;                  // 64-wide column blocks
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;
  int* ids = reinterpret_cast<int*>(sm + S::IDS);

  const int tid = threadIdx.x, wg = tid / 128;
  const int qt = mk.tile_order ? mk.tile_order[blockIdx.x]
                               : gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * WM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int offset = kv_len - q_len;
  bf16* og = o + (size_t)(b * hq + h) * q_len * D;
  float* lg = lse + (size_t)(b * hq + h) * q_len;
  // jagged: columns end at L (the kv length otherwise), rows at L (q_len)
  const int col_end =
      mk.seq_lens ? min(max(mk.seq_lens[b], 0), kv_len) : kv_len;
  const int row_end = mk.seq_lens ? col_end : q_len;
  if (q0 >= row_end) {  // a jagged tile wholly past its row's length
    write_empty_rows<bf16, D>(og, lg, q0, min(WM, q_len - q0));
    return;
  }
  const int hi = min(kv_tiles(q0, WM, q_len, kv_len, causal, WN),
                     (col_end + WN - 1) / WN);
  int lo = mk.tile_lo ? max(0, min(mk.tile_lo[qt], hi - 1)) : 0;
  if (WINDOW) lo = window_lo(lo, hi, q0 + offset, window, WN);
  const int n = hi - lo;                         // kv tiles, at least 1
  const int* kv_ids = SEGS ? mk.kv_seg + (size_t)b * kv_len : nullptr;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    regs_dealloc<PRODUCER_REGS>();
    if (tid % 128 < 32) {
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
          tma_load_3d(sm + S::Q + c * WM * 128, &tm_q, q_full, 64 * c, q0,
                      b * hq + h);
      }
      for (int it = 0; it < n; ++it) {
        const int st = it % STAGES, kv0 = (lo + it) * WN;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
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
    regs_alloc<CONSUMER_REGS>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + wg * 64;                 // the warpgroup's first row
    const unsigned char* qw = sm + S::Q + wg * 64 * 128;  // its q rows
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

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // per-thread partial sums, quad-reduced last

    mbar_wait(q_full, 0);
    if (active) {
      // q * bf16(sm_scale * log2 e), rounded to bf16 (the TPU kernels' q =
      // (q * c).astype(q.dtype)), in place; rows past q_len are TMA's zeros
      const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));
#pragma unroll
      for (int c = 0; c < BOXES; ++c) {
        uint4* p = reinterpret_cast<uint4*>(
            const_cast<unsigned char*>(qw) + c * WM * 128);
        for (int i = t; i < 64 * 128 / 16; i += 128) {
          uint4 raw = p[i];
          bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
          for (int x = 0; x < 8; ++x)
            e[x] = __float2bfloat16_rn(__bfloat162float(e[x]) * qscale);
          p[i] = raw;
        }
      }
      fence_async_smem();  // the generic stores, before wgmma reads them
      named_bar(1 + wg, 128);
    }

    // The mask and the online softmax (log2 domain, one quad of lanes per
    // row) of the S tile at kv0, in place: s becomes p, 0 where masked;
    // alpha gets the factor that rescales O.
    auto softmax = [&](float (&s)[64], int kv0, int st, float (&alpha)[2]) {
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
#pragma unroll
      for (int jj = 0; jj < WN / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * jj + e] = ex2(s[4 * jj + e] - m_new[e >> 1]) * keep[e >> 1];
        rs[0] += s[4 * jj + 0] + s[4 * jj + 1];
        rs[1] += s[4 * jj + 2] + s[4 * jj + 3];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = alpha[r] * l_run[r] + rs[r];
    };
    // P in bf16 (the TPU kernels cast p before the second dot), packed as
    // the A fragments of the PV product, 16 kv columns each
    auto pack_p = [&](const float (&s)[64], uint32_t (&pa)[WN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < WN / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    };
    // S = Q K^T of the tile in stage st: 64 q rows x 128 kv columns
    auto issue_s = [&](float (&s)[64], int st) {
      const unsigned char* kt = sm + S::K + st * S::KV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128<0, 0>(
            s, smem_desc(qw + (kk / 4) * WM * 128 + (kk % 4) * 32, 16, 1024),
            smem_desc(kt + (kk / 4) * WN * 128 + (kk % 4) * 32, 16, 1024),
            kk > 0);
      wgmma_commit();
    };
    // O += P V of the tile in stage st, V read MN-major (its rows are the k
    // dimension)
    auto issue_pv = [&](uint32_t (&pa)[WN / 16][4], int st) {
      const unsigned char* vt = sm + S::V + st * S::KV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WN / 16; ++kk) {
        const uint64_t db = smem_desc(vt + kk * 16 * 128, WN * 128, 1024);
        if constexpr (D == 128) wgmma_rs_n128(oacc, pa[kk], db);
        else wgmma_rs_n64(oacc, pa[kk], db);
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
      float s[64], alpha[2];
      uint32_t pa[WN / 16][4];
      mbar_wait(&k_full[0], 0);
      turn_begin();
      issue_s(s, 0);
      turn_end(false);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, lo * WN, 0, alpha);  // O is 0: nothing to rescale
      pack_p(s, pa);
      for (int it = 1; it < n; ++it) {
        const int st = it % STAGES, prev = (it - 1) % STAGES;
        mbar_wait(&k_full[st], (it / STAGES) & 1);
        mbar_wait(&v_full[prev], ((it - 1) / STAGES) & 1);
        turn_begin();
        issue_s(s, st);
        issue_pv(pa, prev);
        turn_end(false);
        wgmma_wait<1>();  // S, the older group, has landed
        fence_regs(s);
        softmax(s, (lo + it) * WN, st, alpha);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(pa);
        mbar_arrive(&empty[prev]);  // this thread has read stage prev
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          oacc[4 * i + 0] *= alpha[0];
          oacc[4 * i + 1] *= alpha[0];
          oacc[4 * i + 2] *= alpha[1];
          oacc[4 * i + 3] *= alpha[1];
        }
        pack_p(s, pa);
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
      if (row < q_len) {
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const int col = 8 * i + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row * D + col) =
              __floats2bfloat162_rn(oacc[4 * i + 2 * r] / l_safe,
                                    oacc[4 * i + 2 * r + 1] / l_safe);
        }
        if (lane % 4 == 0) lg[row] = m_run[r] * kLn2 + logf(l_safe);
      }
    }
  }
}

template <int D, bool WINDOW, bool SEGS>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, const FwdMasks& mk, int batch,
                         int hq, int hkv, int q_len, int kv_len, int causal,
                         int window, float scale_log2, cudaStream_t stream) {
  using S = FwdSmem<D>;
  const auto kernel = flash_fwd_wgmma_kernel<D, WINDOW, SEGS>;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(kernel, S::ALLOC, smem_set);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mkv[2];
  if (!bf16_map(&mq, q, D, q_len, batch * hq, WM) ||
      !bf16_map(&mkv[0], k, D, kv_len, batch * hkv, WN) ||
      !bf16_map(&mkv[1], v, D, kv_len, batch * hkv, WN))
    return cudaErrorInvalidValue;
  const dim3 grid((q_len + WM - 1) / WM, hq, batch);
  kernel<<<grid, WTHREADS, S::ALLOC, stream>>>(
      mq, mkv[0], mkv[1], static_cast<bf16*>(o), static_cast<float*>(lse),
      mk, hq, hkv, q_len, kv_len, causal, scale_log2, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, const FwdMasks& mk,
                            int batch, int hq, int hkv, int q_len,
                            int kv_len, int causal, int window,
                            float scale_log2, cudaStream_t s) {
  const bool w = window > 0, g = mk.q_seg != nullptr;
  const auto launch = w ? (g ? launch_wgmma<D, true, true>
                             : launch_wgmma<D, true, false>)
                        : (g ? launch_wgmma<D, false, true>
                             : launch_wgmma<D, false, false>);
  return launch(q, k, v, o, lse, mk, batch, hq, hkv, q_len, kv_len, causal,
                window, scale_log2, s);
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. dtype: 0 bf16,
// 1 f32. head_dim: 64 or 128. q_seg, kv_seg, tile_lo, tile_order and
// seq_lens may each be null (FwdMasks); tile_lo and tile_order hold one
// int per q tile of this dtype's block_m. window: 0 for none, else >= 1
// with causal and without seq_lens. The caller has checked shapes,
// contiguity and 16-byte alignment. A bf16 launch whose tensor maps cannot
// be encoded returns cudaErrorInvalidValue.
extern "C" int tfa_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, const void* q_seg,
                             const void* kv_seg, const void* tile_lo,
                             const void* tile_order, const void* seq_lens,
                             int batch, int hq, int hkv, int q_len,
                             int kv_len, int head_dim, int causal,
                             int window, float scale_log2, int dtype,
                             void* stream) {
  if (!fwd_args_valid(batch, hq, hkv, q_len, kv_len, q_seg, kv_seg, seq_lens,
                      causal, window))
    return (int)cudaErrorInvalidValue;
  const FwdMasks mk{static_cast<const int*>(q_seg),
                    static_cast<const int*>(kv_seg),
                    static_cast<const int*>(tile_lo),
                    static_cast<const int*>(tile_order),
                    static_cast<const int*>(seq_lens)};
  const KvScales none{nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 128)
    return (int)launch_bf16_fwd<128>(q, k, v, o, lse, mk, batch, hq, hkv,
                                     q_len, kv_len, causal, window,
                                     scale_log2, s);
  if (dtype == 0 && head_dim == 64)
    return (int)launch_bf16_fwd<64>(q, k, v, o, lse, mk, batch, hq, hkv,
                                    q_len, kv_len, causal, window,
                                    scale_log2, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_f32<128, kNone>(q, k, v, o, lse, mk, none, batch, hq,
                                       hkv, q_len, kv_len, causal, window,
                                       scale_log2, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_f32<64, kNone>(q, k, v, o, lse, mk, none, batch, hq,
                                      hkv, q_len, kv_len, causal, window,
                                      scale_log2, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory one block of the instance for dtype (0 bf16,
// 1 f32) and head_dim (64 or 128) takes; -1 for any other. ops/flash.py
// holds ops/configs.py::fwd_smem_bytes to it when it loads this library.
extern "C" int tfa_flash_fwd_smem(int dtype, int head_dim) {
  if (dtype == 0 && head_dim == 128) return FwdSmem<128>::ALLOC;
  if (dtype == 0 && head_dim == 64) return FwdSmem<64>::ALLOC;
  if (dtype == 1 && head_dim == 128) return f32_smem_bytes<128, kNone>();
  if (dtype == 1 && head_dim == 64) return f32_smem_bytes<64, kNone>();
  return -1;
}
