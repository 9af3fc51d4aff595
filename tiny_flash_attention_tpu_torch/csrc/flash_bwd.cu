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
// Contract: q, dout (B, hq, Sq, D) and k, v (B, hkv, Skv, D), contiguous, of
// one dtype; lse (B, hq, Sq) is the forward's natural-log LSE and delta
// (B, hq, Sq) = rowsum(dout * out), both f32 (the wrapper computes delta, as
// the JAX package does in XLA outside its kernels). Causal rows sit at
// position row + Skv - Sq. Writes dq like q, and dk, dv like k, with dk and
// dv summed over the GQA group of each kv head.
//
// Arithmetic (the work-list kernels' rounding points, flash_bwd.py:173, so
// the recomputed p matches the LSE that flash_fwd.cu wrote with the same
// fold): s2 = (q * scale_log2 rounded to the input dtype) k^T in f32;
// p = exp2(s2 - lse * log2 e), 0 where masked and on rows whose LSE is the
// empty-row sentinel; dp = dout v^T; ds = p (dp - delta). The tensor cores
// take p and ds rounded to bf16 and accumulate in f32:
// dv = sum p^T dout, dk = sm_scale sum ds^T q, dq = sm_scale sum ds k, each
// rounded once at the write. The f32 kernels run in f32 FMAs on the CUDA
// cores (never TF32; the f32 gate is 2e-5) and round nothing in between.
//
// Design: the split backward (the layout of _bwd_dq_kernel/_bwd_dkv_kernel),
// deterministic, with no atomics.
//   flash_bwd_dkv: one block per (64-row kv tile, kv head, batch); K and V
//     stay in shared memory while the block walks the group's q heads and,
//     per head, the q tiles the causal clamp lets see this kv tile. Each of
//     the 4 warps owns 16 kv rows and keeps their dk and dv in registers, so
//     the GQA sum happens inside the block. q, dout, lse and delta tiles of
//     32 rows stream through a two-stage cp.async ring.
//   flash_bwd_dq: one block per (64-row q tile, q head, batch), longest
//     causal rows first; each warp owns 16 q rows and keeps dq in registers
//     while K/V tiles of 64 rows stream through a two-stage cp.async ring.
// Both use mma.sync m16n8k16 (bf16 in, f32 accumulate); every product keeps
// its left operand in the accumulator-as-A-fragment layout of
// flash_common.cuh, so p and ds never leave registers.
//
// What bounds it: tensor-core FLOPs. The least work is 5 products per
// visible (row, column) pair (s, dp, dv, dk, dq: 2.5x the forward's 4 * D
// flops per pair); this split design does 7, because each kernel recomputes
// s and dp. At (4, 8, 2048, 128) causal the bound is 85.9 GFLOP over
// 989 TF/s = 0.087 ms; at (1, 8, 8192, 128) 343.6 GFLOP, 0.347 ms.
//
// Tile sizes come from tiny_flash_attention_tpu_torch/ops/configs.py as -D
// defines; the build refuses to compile without them.

#include "flash_common.cuh"

#if !defined(TFA_BWD_BF16_DQ_BLOCK_M) || !defined(TFA_BWD_BF16_DQ_BLOCK_N) ||   \
    !defined(TFA_BWD_BF16_DQ_THREADS) || !defined(TFA_BWD_BF16_DKV_BLOCK_M) || \
    !defined(TFA_BWD_BF16_DKV_BLOCK_N) ||                                      \
    !defined(TFA_BWD_BF16_DKV_THREADS) || !defined(TFA_BWD_F32_BLOCK_M) ||     \
    !defined(TFA_BWD_F32_BLOCK_N) || !defined(TFA_BWD_F32_THREADS)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;  // bf16 per smem row: rows land 16 bytes apart in banks

// The LSE in the log2 domain, or +inf on rows that carry the empty-row
// sentinel (and on padding rows), so that exp2(s - lse2) is 0 there.
__device__ __forceinline__ float lse2_of(float lse) {
  const float l2 = lse * kLog2e;
  return l2 > 0.5f * kMaskValue ? l2 : INFINITY;
}

// A row-major 16-row slab of a bf16 smem tile as an mma A fragment.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld,
                                       int row0, int k0, int lane) {
  const int row = row0 + (lane % 8) + ((lane / 8) & 1) * 8;
  ldsm_x4(a, tile + row * ld + k0 + (lane / 16) * 8);
}

// B fragments of n-tiles nt, nt + 1 at depth k0 from a tile stored [n][k].
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* tile, int ld,
                                       int nt, int k0, int lane) {
  const int mi = lane / 8;
  ldsm_x4(b, tile + (nt * 8 + (mi >> 1) * 8 + lane % 8) * ld + k0 +
                 (mi & 1) * 8);
}

// B fragments of n-tiles dn, dn + 1 at depth k0 from a tile stored [k][n].
__device__ __forceinline__ void load_b_trans(uint32_t* b, const bf16* tile,
                                             int ld, int dn, int k0,
                                             int lane) {
  const int mi = lane / 8;
  ldsm_x4_trans(b, tile + (k0 + (mi & 1) * 8 + lane % 8) * ld +
                       (dn + (mi >> 1)) * 8);
}

// acc (16 x 8 * NT) += a (16 x D, smem rows row0..) * b^T (b stored [n][k])
template <int D, int NT>
__device__ __forceinline__ void mma_abt_smem(float (*acc)[4], const bf16* a,
                                             int row0, const bf16* b,
                                             int lane) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a(af, a, LD, row0, kk * 16, lane);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bb[4];
      load_b(bb, b, LD, nt, kk * 16, lane);
      mma_16816(acc[nt], af, bb[0], bb[1]);
      mma_16816(acc[nt + 1], af, bb[2], bb[3]);
    }
  }
}

// acc (16 x D) += a (16 x 16 * KT, register fragments) * b (stored [k][n])
template <int D, int KT>
__device__ __forceinline__ void mma_ab_regs(float (*acc)[4], uint32_t (*a)[4],
                                            const bf16* b, int lane) {
  constexpr int LD = D + PAD;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int dn = 0; dn < D / 8; dn += 2) {
      uint32_t bb[4];
      load_b_trans(bb, b, LD, dn, kk * 16, lane);
      mma_16816(acc[dn], a[kk], bb[0], bb[1]);
      mma_16816(acc[dn + 1], a[kk], bb[2], bb[3]);
    }
  }
}

// Packs a 16 x 8 * NT accumulator to bf16 A fragments (16 x 16 * NT / 2).
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (*a)[4], float (*c)[4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    a[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(c[nt][0], c[nt][1]);
    a[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Writes a warp's 16 x D accumulator times `scale` as bf16 rows row0.. of g.
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, float (*acc)[4],
                                           int row0, int n_rows, float scale,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + lane / 4 + r * 8;
    if (row >= n_rows) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(g + (size_t)row * D + col) =
          __floats2bfloat162_rn(acc[dn][2 * r] * scale,
                                acc[dn][2 * r + 1] * scale);
    }
  }
}

// ------------------------------------------------------------ bf16 dk / dv

constexpr int KM = TFA_BWD_BF16_DKV_BLOCK_M;  // q rows per step
constexpr int KN = TFA_BWD_BF16_DKV_BLOCK_N;  // kv rows per block
constexpr int KTHREADS = TFA_BWD_BF16_DKV_THREADS;
static_assert(KN == KTHREADS / 32 * 16, "each warp owns 16 kv rows");
static_assert(KM % 16 == 0, "the q step is a multiple of the mma depth");

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V; per stage q, q scaled, dout; per stage lse2 and delta
  return (2 * KN + 2 * 3 * KM) * (D + PAD) * (int)sizeof(bf16) +
         2 * 2 * KM * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(KTHREADS)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int hq, int hkv, int q_len, int kv_len,
                              int causal, float scale_log2, float sm_scale) {
  constexpr int LD = D + PAD;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int STAGE = 3 * KM * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [KN][LD]
  bf16* vs = ks + KN * LD;                       // [KN][LD]
  bf16* ring = vs + KN * LD;  // [2] x {q [KM][LD], q scaled, dout}
  float* stats = reinterpret_cast<float*>(ring + 2 * STAGE);  // [2][2][KM]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kv0 = blockIdx.x * KN;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int offset = kv_len - q_len;
  // the first q row that sees column kv0 (always < q_len: the last row sits
  // at position kv_len - 1)
  const int first_row = causal ? max(0, kv0 - offset) : 0;
  const int qt0 = first_row / KM;
  const int n_qt = (q_len + KM - 1) / KM - qt0;
  const int n_it = group * n_qt;  // (head, q tile) steps, heads outer

  const bf16* kg = k + ((size_t)(b * hkv + kvh) * kv_len) * D;
  const bf16* vg = v + ((size_t)(b * hkv + kvh) * kv_len) * D;
  for (int c = tid; c < KN * CH; c += KTHREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool valid = kv0 + r < kv_len;
    const size_t src = (size_t)(valid ? kv0 + r : 0) * D + col;
    cp_async16(ks + r * LD + col, kg + src, valid);
    cp_async16(vs + r * LD + col, vg + src, valid);
  }

  auto load_step = [&](int it, int st) {
    const int h = kvh * group + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * KM;
    const size_t head = (size_t)(b * hq + h) * q_len;
    bf16* qd = ring + st * STAGE;
    bf16* dd = qd + 2 * KM * LD;
    for (int c = tid; c < KM * CH; c += KTHREADS) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool valid = q0 + r < q_len;
      const size_t src = (head + (valid ? q0 + r : 0)) * D + col;
      cp_async16(qd + r * LD + col, q + src, valid);
      cp_async16(dd + r * LD + col, dout + src, valid);
    }
    float* sd = stats + st * 2 * KM;
    for (int r = tid; r < KM; r += KTHREADS) {
      const bool valid = q0 + r < q_len;
      const size_t src = head + (valid ? q0 + r : 0);
      cp_async4(sd + r, lse + src, valid);
      cp_async4(sd + KM + r, delta + src, valid);
    }
  };

  load_step(0, 0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
  zero<D / 8>(dka);
  zero<D / 8>(dva);
  const int kv_warp = kv0 + warp * 16;
  const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) load_step(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + it % n_qt) * KM;
    bf16* qr = ring + st * STAGE;  // q as stored
    bf16* qsc = qr + KM * LD;
    const bf16* dos = qr + 2 * KM * LD;
    float* sd = stats + st * 2 * KM;

    // q scaled by sm_scale*log2(e) rounded to bf16, product rounded to bf16
    // (the forward's fold), beside q as stored (for dK)
    for (int c = tid; c < KM * CH; c += KTHREADS) {
      const int r = c / CH, col = (c % CH) * 8;
      uint4 raw = *reinterpret_cast<const uint4*>(qr + r * LD + col);
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * qscale);
      *reinterpret_cast<uint4*>(qsc + r * LD + col) = raw;
    }
    __syncthreads();

    // S^T = K Qs^T: 16 kv rows x KM q columns per warp
    float s[KM / 8][4];
    zero<KM / 8>(s);
    mma_abt_smem<D, KM / 8>(s, ks, warp * 16, qsc, lane);

    const bool need_mask = q0 + KM > q_len || kv_warp + 16 > kv_len ||
                           (causal && kv_warp + 15 > q0 + offset);
#pragma unroll
    for (int nt = 0; nt < KM / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = nt * 8 + (lane % 4) * 2 + (i & 1);
        float p = exp2f(s[nt][i] - lse2_of(sd[qc]));
        if (need_mask) {
          const int row = q0 + qc, col = kv_warp + lane / 4 + (i >> 1) * 8;
          if (!(row < q_len && col < kv_len && (!causal || col <= row + offset)))
            p = 0.f;
        }
        s[nt][i] = p;
      }
    }

    // dV += P^T dout
    uint32_t pa[KM / 16][4];
    pack_a<KM / 8>(pa, s);
    mma_ab_regs<D, KM / 16>(dva, pa, dos, lane);

    // dP^T = V dout^T, then dS^T = P^T (dP^T - delta)
    float dp[KM / 8][4];
    zero<KM / 8>(dp);
    mma_abt_smem<D, KM / 8>(dp, vs, warp * 16, dos, lane);
#pragma unroll
    for (int nt = 0; nt < KM / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qc = nt * 8 + (lane % 4) * 2 + (i & 1);
        dp[nt][i] = s[nt][i] * (dp[nt][i] - sd[KM + qc]);
      }
    }

    // dK += dS^T q (q as stored, not scaled)
    uint32_t dsa[KM / 16][4];
    pack_a<KM / 8>(dsa, dp);
    mma_ab_regs<D, KM / 16>(dka, dsa, qr, lane);
    __syncthreads();  // this stage is refilled at the next step
  }

  const size_t base = (size_t)(b * hkv + kvh) * kv_len * D;
  store_rows<D>(dk + base, dka, kv_warp, kv_len, sm_scale, lane);
  store_rows<D>(dv + base, dva, kv_warp, kv_len, 1.f, lane);
}

// --------------------------------------------------------------- bf16 dq

constexpr int QM = TFA_BWD_BF16_DQ_BLOCK_M;  // q rows per block
constexpr int QN = TFA_BWD_BF16_DQ_BLOCK_N;  // kv rows per step
constexpr int QTHREADS = TFA_BWD_BF16_DQ_THREADS;
static_assert(QM == QTHREADS / 32 * 16, "each warp owns 16 q rows");
static_assert(QN % 16 == 0, "the kv step is a multiple of the mma depth");

template <int D>
constexpr int dq_smem_bytes() {
  // q scaled, dout; two stages of K and V
  return (2 * QM + 4 * QN) * (D + PAD) * (int)sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(QTHREADS)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int hq, int hkv,
                             int q_len, int kv_len, int causal,
                             float scale_log2, float sm_scale) {
  constexpr int LD = D + PAD;
  constexpr int CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [QM][LD], scaled
  bf16* dos = qs + QM * LD;                      // [QM][LD]
  bf16* ks = dos + QM * LD;                      // [2][QN][LD]
  bf16* vs = ks + 2 * QN * LD;                   // [2][QN][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QM;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int offset = kv_len - q_len;
  const size_t head = (size_t)(b * hq + h) * q_len;
  const bf16* qg = q + head * D;
  const bf16* dog = dout + head * D;
  const bf16* kg = k + (size_t)(b * hkv + kvh) * kv_len * D;
  const bf16* vg = v + (size_t)(b * hkv + kvh) * kv_len * D;
  const int n_tiles = kv_tiles(q0, QM, q_len, kv_len, causal, QN);

  auto load_kv = [&](int tile, int buf) {
    const int kv0 = tile * QN;
    bf16* kd = ks + buf * QN * LD;
    bf16* vd = vs + buf * QN * LD;
    for (int c = tid; c < QN * CH; c += QTHREADS) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool valid = kv0 + r < kv_len;
      const size_t src = (size_t)(valid ? kv0 + r : 0) * D + col;
      cp_async16(kd + r * LD + col, kg + src, valid);
      cp_async16(vd + r * LD + col, vg + src, valid);
    }
  };

  load_kv(0, 0);
  for (int c = tid; c < QM * CH; c += QTHREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool valid = q0 + r < q_len;
    cp_async16(dos + r * LD + col,
               dog + (size_t)(valid ? q0 + r : 0) * D + col, valid);
  }
  cp_async_commit();

  // q scaled as in the forward: (q * bf16(scale_log2)) rounded to bf16
  const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));
  for (int c = tid; c < QM * CH; c += QTHREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < q_len)
      raw = *reinterpret_cast<const uint4*>(qg + (size_t)(q0 + r) * D + col);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * qscale);
    *reinterpret_cast<uint4*>(qs + r * LD + col) = raw;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qa[kk], qs, LD, warp * 16, kk * 16, lane);

  // this thread's rows: qrow (accumulator slots 0, 1) and qrow + 8 (2, 3)
  const int qrow = q0 + warp * 16 + lane / 4;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + r * 8;
    lse2[r] = row < q_len ? lse2_of(lse[head + row]) : INFINITY;
    dlt[r] = row < q_len ? delta[head + row] : 0.f;
  }
  const int warp_first_pos = q0 + warp * 16 + offset;

  float dqa[D / 8][4];
  zero<D / 8>(dqa);
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + buf * QN * LD;
    const bf16* vt = vs + buf * QN * LD;

    // S = Qs K^T (q fragments in registers)
    float s[QN / 8][4];
    zero<QN / 8>(s);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < QN / 8; nt += 2) {
        uint32_t bb[4];
        load_b(bb, kt, LD, nt, kk * 16, lane);
        mma_16816(s[nt], qa[kk], bb[0], bb[1]);
        mma_16816(s[nt + 1], qa[kk], bb[2], bb[3]);
      }
    }
    // dP = dout V^T
    float dp[QN / 8][4];
    zero<QN / 8>(dp);
    mma_abt_smem<D, QN / 8>(dp, dos, warp * 16, vt, lane);

    const int kv0 = j * QN;
    const bool need_mask =
        kv0 + QN > kv_len || (causal && kv0 + QN - 1 > warp_first_pos);
#pragma unroll
    for (int nt = 0; nt < QN / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        float p = exp2f(s[nt][i] - lse2[r]);
        if (need_mask) {
          const int col = kv0 + nt * 8 + (lane % 4) * 2 + (i & 1);
          if (!(col < kv_len && (!causal || col <= qrow + r * 8 + offset)))
            p = 0.f;
        }
        dp[nt][i] = p * (dp[nt][i] - dlt[r]);
      }
    }

    // dQ += dS K
    uint32_t dsa[QN / 16][4];
    pack_a<QN / 8>(dsa, dp);
    mma_ab_regs<D, QN / 16>(dqa, dsa, kt, lane);
    __syncthreads();  // the buffer is refilled two steps from now
  }

  store_rows<D>(dq + head * D, dqa, q0 + warp * 16, q_len, sm_scale, lane);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dq, void* dk, void* dv,
                        int batch, int hq, int hkv, int q_len, int kv_len,
                        int causal, float scale_log2, float sm_scale,
                        cudaStream_t stream) {
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  if (dq != nullptr) {
    static bool smem_set[kMaxDevices] = {};
    cudaError_t err = raise_smem_limit(flash_bwd_dq_bf16_kernel<D>,
                                       dq_smem_bytes<D>(), smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((q_len + QM - 1) / QM, hq, batch);
    flash_bwd_dq_bf16_kernel<D><<<grid, QTHREADS, dq_smem_bytes<D>(),
                                  stream>>>(
        qb, kb, vb, db, lse, delta, static_cast<bf16*>(dq), hq, hkv, q_len,
        kv_len, causal, scale_log2, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dk != nullptr) {
    static bool smem_set[kMaxDevices] = {};
    cudaError_t err = raise_smem_limit(flash_bwd_dkv_bf16_kernel<D>,
                                       dkv_smem_bytes<D>(), smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((kv_len + KN - 1) / KN, hkv, batch);
    flash_bwd_dkv_bf16_kernel<D><<<grid, KTHREADS, dkv_smem_bytes<D>(),
                                   stream>>>(
        qb, kb, vb, db, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), hq, hkv, q_len, kv_len, causal, scale_log2,
        sm_scale);
    err = cudaGetLastError();
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

template <int D>
constexpr int f32_smem_bytes() {
  return (4 * D * PT + 64 * PS + 2 * 64) * (int)sizeof(float);
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

template <int D>
__global__ void __launch_bounds__(FTHREADS)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int hq, int hkv, int q_len, int kv_len,
                             int causal, float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* kt = reinterpret_cast<float*>(smem_raw);  // [D][PT] this block's K
  float* vt = kt + D * PT;                         // [D][PT] this block's V
  float* qt = vt + D * PT;                         // [D][PT] q as stored
  float* dot = qt + D * PT;                        // [D][PT] dout
  float* ps = dot + D * PT;                        // [64][PS] P^T, then dS^T
  float* l2s = ps + 64 * PS;                       // [64] lse2 of the q tile
  float* dls = l2s + 64;                           // [64] delta of the q tile

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int kv0 = blockIdx.x * FN;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int offset = kv_len - q_len;
  const int first_row = causal ? max(0, kv0 - offset) : 0;
  const int qt0 = first_row / FM;
  const int n_qt = (q_len + FM - 1) / FM - qt0;
  const size_t kv_base = (size_t)(b * hkv + kvh) * kv_len * D;

  load_t<D>(kt, k + kv_base, kv0, kv_len, 1.f, tid);
  load_t<D>(vt, v + kv_base, kv0, kv_len, 1.f, tid);

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int it = 0; it < group * n_qt; ++it) {
    const int h = kvh * group + it / n_qt;
    const int q0 = (qt0 + it % n_qt) * FM;
    const size_t head = (size_t)(b * hq + h) * q_len;
    __syncthreads();  // the previous step's tiles are no longer read
    load_t<D>(qt, q + head * D, q0, q_len, 1.f, tid);
    load_t<D>(dot, dout + head * D, q0, q_len, 1.f, tid);
    for (int r = tid; r < FM; r += FTHREADS) {
      const bool valid = q0 + r < q_len;
      l2s[r] = valid ? lse2_of(lse[head + q0 + r]) : INFINITY;
      dls[r] = valid ? delta[head + q0 + r] : 0.f;
    }
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
        const int row = q0 + qc, col = kv0 + rg * 4 + i;
        float p = exp2f(s[i][j] - l2s[qc]);
        if (!(row < q_len && col < kv_len && (!causal || col <= row + offset)))
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
                            float* __restrict__ dq, int hq, int hkv,
                            int q_len, int kv_len, int causal,
                            float scale_log2, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt = reinterpret_cast<float*>(smem_raw);  // [D][PT] q scaled
  float* dot = qt + D * PT;                        // [D][PT] dout
  float* kt = dot + D * PT;                        // [D][PT] K tile
  float* vt = kt + D * PT;                         // [D][PT] V tile
  float* dss = vt + D * PT;                        // [64][PS] dS

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FM;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int offset = kv_len - q_len;
  const size_t head = (size_t)(b * hq + h) * q_len;
  const size_t kv_base = (size_t)(b * hkv + kvh) * kv_len * D;
  const int n_tiles = kv_tiles(q0, FM, q_len, kv_len, causal, FN);

  load_t<D>(qt, q + head * D, q0, q_len, scale_log2, tid);
  load_t<D>(dot, dout + head * D, q0, q_len, 1.f, tid);
  float lse2[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    lse2[i] = row < q_len ? lse2_of(lse[head + row]) : INFINITY;
    dlt[i] = row < q_len ? delta[head + row] : 0.f;
  }

  float dqa[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dqa[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = t * FN;
    __syncthreads();  // the previous tile's kt / vt / dss are no longer read
    load_t<D>(kt, k + kv_base, kv0, kv_len, 1.f, tid);
    load_t<D>(vt, v + kv_base, kv0, kv_len, 1.f, tid);
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
        if (!(col < kv_len && (!causal || col <= row + offset))) p = 0.f;
        dss[(rg * 4 + i) * PS + cg + 16 * j] = p * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();
    tile_accumulate<D>(dqa, dss, kt, rg, cg);  // dQ += dS K
  }

  store_f32<D>(dq + head * D, dqa, q0, q_len, sm_scale, rg, cg);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dq, void* dk, void* dv, int batch, int hq,
                       int hkv, int q_len, int kv_len, int causal,
                       float scale_log2, float sm_scale,
                       cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const int smem = f32_smem_bytes<D>();
  if (dq != nullptr) {
    static bool smem_set[kMaxDevices] = {};
    cudaError_t err =
        raise_smem_limit(flash_bwd_dq_f32_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((q_len + FM - 1) / FM, hq, batch);
    flash_bwd_dq_f32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
        qf, kf, vf, df, lse, delta, static_cast<float*>(dq), hq, hkv, q_len,
        kv_len, causal, scale_log2, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dk != nullptr) {
    static bool smem_set[kMaxDevices] = {};
    cudaError_t err =
        raise_smem_limit(flash_bwd_dkv_f32_kernel<D>, smem, smem_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((kv_len + FN - 1) / FN, hkv, batch);
    flash_bwd_dkv_f32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
        qf, kf, vf, df, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), hq, hkv, q_len, kv_len, causal, scale_log2,
        sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Returns a cudaError_t: 0 when the kernels were launched. Launches the dq
// kernel when dq is not null and the dk/dv kernel when dk (and dv) are not
// null. dtype: 0 bf16, 1 f32. head_dim: 64 or 128. The caller has checked
// shapes, contiguity and 16-byte alignment.
extern "C" int tfa_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int batch, int hq, int hkv, int q_len,
                             int kv_len, int head_dim, int causal,
                             float scale_log2, float sm_scale, int dtype,
                             void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || q_len <= 0 ||
      kv_len <= 0 || (dk == nullptr) != (dv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0 && head_dim == 128)
    return (int)launch_bf16<128>(q, k, v, dout, l, dl, dq, dk, dv, batch, hq,
                                 hkv, q_len, kv_len, causal, scale_log2,
                                 sm_scale, s);
  if (dtype == 0 && head_dim == 64)
    return (int)launch_bf16<64>(q, k, v, dout, l, dl, dq, dk, dv, batch, hq,
                                hkv, q_len, kv_len, causal, scale_log2,
                                sm_scale, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_f32<128>(q, k, v, dout, l, dl, dq, dk, dv, batch, hq,
                                hkv, q_len, kv_len, causal, scale_log2,
                                sm_scale, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_f32<64>(q, k, v, dout, l, dl, dq, dk, dv, batch, hq,
                               hkv, q_len, kv_len, causal, scale_log2,
                               sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
