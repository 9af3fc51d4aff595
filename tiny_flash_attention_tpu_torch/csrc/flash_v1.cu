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
// What bounds it: at S 2048 the tensor-core FLOPs of the visible pairs, as
// FA2, plus what FA1 adds: every (q tile, KV tile) step reads and writes the
// tile's f32 accumulator (64 x D x 4 bytes each way) and reloads the q tile,
// hundreds of MB per call, mostly served from L2. The design: a block of 4
// warps (bf16: mma.sync m16n8k16 as in flash_fwd.cu; f32: 16 x 16 threads on
// the CUDA cores, never TF32) takes Q_TILES q tiles of one head, interleaved
// (block x takes tiles x, x + gridDim.x, ...) so causal work evens out. Per
// KV tile it stages K and V in shared memory once and walks its q tiles, each
// step loading the tile's state, running the online softmax update, and
// storing the state back, or at the tile's last visible KV tile writing out
// and the LSE.
//
// Tile sizes come from tiny_flash_attention_tpu_torch/ops/configs.py as -D
// defines.

#include "flash_common.cuh"

#if !defined(TFA_V1_BF16_BLOCK_M) || !defined(TFA_V1_BF16_BLOCK_N) || \
    !defined(TFA_V1_BF16_THREADS) || !defined(TFA_V1_F32_BLOCK_M) ||   \
    !defined(TFA_V1_F32_BLOCK_N) || !defined(TFA_V1_F32_THREADS) ||    \
    !defined(TFA_V1_Q_TILES)
#error "tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

// The running state of every q row of every head, in global memory: rows
// padded to whole q tiles.
struct V1State {
  float* m;    // (B * H, rows) running max (log2 domain)
  float* l;    // (B * H, rows) running sum
  float* acc;  // (B * H, rows, D) unnormalized output
  int rows;
};

// ---------------------------------------------------------------- bf16 path

constexpr int BM = TFA_V1_BF16_BLOCK_M;
constexpr int BN = TFA_V1_BF16_BLOCK_N;
constexpr int THREADS = TFA_V1_BF16_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 8;  // bf16 per smem row: rows land 16 bytes apart in banks
static_assert(BM == WARPS * 16, "each warp owns 16 q rows");
static_assert(BN % 16 == 0, "kv tile is a multiple of the mma depth");

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_v1_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, V1State st, int q_len,
                         int kv_len, int causal, float scale_log2) {
  constexpr int LD = D + PAD;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BN][LD]
  __nv_bfloat16* vs = ks + BN * LD;                                // [BN][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int offset = kv_len - q_len;
  const int n_q = (q_len + BM - 1) / BM;
  const __nv_bfloat16* qg = q + (size_t)bh * q_len * D;
  const __nv_bfloat16* kg = k + (size_t)bh * kv_len * D;
  const __nv_bfloat16* vg = v + (size_t)bh * kv_len * D;
  __nv_bfloat16* og = o + (size_t)bh * q_len * D;
  float* lg = lse + (size_t)bh * q_len;
  float* mg = st.m + (size_t)bh * st.rows;
  float* sg = st.l + (size_t)bh * st.rows;
  float* ag = st.acc + (size_t)bh * st.rows * D;
  // q scaled by sm_scale*log2(e) rounded to bf16, product rounded to bf16
  const float qscale = __bfloat162float(__float2bfloat16_rn(scale_log2));

  int kv_end = 0;  // KV tiles up to the last one any of this block's tiles sees
  for (int qt = blockIdx.x; qt < n_q; qt += gridDim.x)
    kv_end = max(kv_end, kv_tiles(qt * BM, BM, q_len, kv_len, causal, BN));

  for (int j = 0; j < kv_end; ++j) {  // the outer loop: KV tiles
    const int kv0 = j * BN;
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int c = tid; c < BN * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 8;
      const bool valid = kv0 + r < kv_len;
      const size_t src = (size_t)(valid ? kv0 + r : 0) * D + col;
      cp_async16(ks + r * LD + col, kg + src, valid);
      cp_async16(vs + r * LD + col, vg + src, valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    for (int qt = blockIdx.x; qt < n_q; qt += gridDim.x) {  // inner: q tiles
      const int q0 = qt * BM;
      const int hi = kv_tiles(q0, BM, q_len, kv_len, causal, BN);
      if (j >= hi) continue;
      // this thread's rows: qrow (accumulator slots 0,1), qrow + 8 (2,3)
      const int qrow = q0 + warp * 16 + lane / 4;
      const int warp_first_pos = q0 + warp * 16 + offset;

      // the q tile, reloaded on every KV step: A fragments straight from
      // global memory (a[0] rows 0-7 / k 0-7, a[1] rows 8-15, a[2] k 8-15)
      uint32_t qa[D / 16][4];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = qrow + (i & 1) * 8;
          const int col = kk * 16 + (i >> 1) * 8 + (lane % 4) * 2;
          __nv_bfloat162 x = __floats2bfloat162_rn(0.f, 0.f);
          if (row < q_len)
            x = *reinterpret_cast<const __nv_bfloat162*>(
                qg + (size_t)row * D + col);
          qa[kk][i] = pack_bf16(__bfloat162float(x.x) * qscale,
                                __bfloat162float(x.y) * qscale);
        }
      }

      // the tile's state: initial at the first KV tile, else reloaded
      float oacc[D / 8][4];
      float m_run[2], l_run[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qrow + r * 8;
        m_run[r] = j == 0 ? -INFINITY : mg[row];
        l_run[r] = j == 0 ? 0.f : sg[row];
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          float2 a = make_float2(0.f, 0.f);
          if (j > 0)
            a = *reinterpret_cast<const float2*>(
                ag + (size_t)row * D + dn * 8 + (lane % 4) * 2);
          oacc[dn][2 * r] = a.x;
          oacc[dn][2 * r + 1] = a.y;
        }
      }

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
          ldsm_x4(bb, ks + (nt * 8 + (mi >> 1) * 8 + lane % 8) * LD +
                          kk * 16 + (mi & 1) * 8);
          mma_16816(s[nt], qa[kk], bb[0], bb[1]);
          mma_16816(s[nt + 1], qa[kk], bb[2], bb[3]);
        }
      }
      if (kv0 + BN > kv_len || (causal && kv0 + BN - 1 > warp_first_pos)) {
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = kv0 + nt * 8 + (lane % 4) * 2 + (i & 1);
            const int row = qrow + (i >> 1) * 8;
            if (col >= kv_len || (causal && col > row + offset))
              s[nt][i] = kMaskValue;
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
        // a row that has seen only masked columns keeps m at the mask floor
        keep[r] = mx > 0.5f * kMaskValue ? 1.f : 0.f;
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
        pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
        pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_run[r] = alpha[r] * l_run[r] + rs[r];
        m_run[r] = m_new[r];
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        oacc[dn][0] *= alpha[0];
        oacc[dn][1] *= alpha[0];
        oacc[dn][2] *= alpha[1];
        oacc[dn][3] *= alpha[1];
      }
      // O += P V (P in bf16)
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < D / 8; dn += 2) {
          uint32_t bb[4];
          const int mi = lane / 8;
          ldsm_x4_trans(bb, vs + (kk * 16 + (mi & 1) * 8 + lane % 8) * LD +
                                (dn + (mi >> 1)) * 8);
          mma_16816(oacc[dn], pa[kk], bb[0], bb[1]);
          mma_16816(oacc[dn + 1], pa[kk], bb[2], bb[3]);
        }
      }

      const bool last = j == hi - 1;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qrow + r * 8;
        if (!last) {  // FA1's signature cost: the state goes back to memory
          if (lane % 4 == 0) {
            mg[row] = m_run[r];
            sg[row] = l_run[r];
          }
#pragma unroll
          for (int dn = 0; dn < D / 8; ++dn)
            *reinterpret_cast<float2*>(ag + (size_t)row * D + dn * 8 +
                                       (lane % 4) * 2) =
                make_float2(oacc[dn][2 * r], oacc[dn][2 * r + 1]);
        } else if (row < q_len) {
          const float l = l_run[r];
          const float l_safe = (l == 0.f || l != l) ? 1.f : l;
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
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        void* lse, const V1State& st, int bh, int q_len,
                        int kv_len, int causal, float scale_log2,
                        cudaStream_t stream) {
  const int smem = 2 * BN * (D + PAD) * (int)sizeof(__nv_bfloat16);
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(flash_v1_bf16_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int n_q = (q_len + BM - 1) / BM;
  const dim3 grid((n_q + TFA_V1_Q_TILES - 1) / TFA_V1_Q_TILES, bh);
  flash_v1_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), st, q_len, kv_len, causal, scale_log2);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path

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
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, const V1State& st, int bh, int q_len,
                       int kv_len, int causal, float scale_log2,
                       cudaStream_t stream) {
  const int smem =
      (D * FM + D * FN + FN * D + FM * (FN + 1)) * (int)sizeof(float);
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(flash_v1_f32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int n_q = (q_len + FM - 1) / FM;
  const dim3 grid((n_q + TFA_V1_Q_TILES - 1) / TFA_V1_Q_TILES, bh);
  flash_v1_f32_kernel<D><<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), st, q_len, kv_len, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. bh = batch *
// heads; dtype: 0 bf16, 1 f32; head_dim: 64 or 128. m_scratch and
// l_scratch hold (bh, state_rows) f32, acc_scratch (bh, state_rows,
// head_dim) f32, state_rows = q_len rounded up to this dtype's block_m;
// they need no initial values. The caller has checked shapes, contiguity
// and 16-byte alignment.
extern "C" int tfa_flash_v1(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* m_scratch,
                            void* l_scratch, void* acc_scratch,
                            int state_rows, int bh, int q_len, int kv_len,
                            int head_dim, int causal, float scale_log2,
                            int dtype, void* stream) {
  const int bm = dtype == 0 ? BM : FM;
  if (bh <= 0 || q_len <= 0 || kv_len <= 0 ||
      state_rows < (q_len + bm - 1) / bm * bm)
    return (int)cudaErrorInvalidValue;
  const V1State st{static_cast<float*>(m_scratch),
                   static_cast<float*>(l_scratch),
                   static_cast<float*>(acc_scratch), state_rows};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 128)
    return (int)launch_bf16<128>(q, k, v, o, lse, st, bh, q_len, kv_len,
                                 causal, scale_log2, s);
  if (dtype == 0 && head_dim == 64)
    return (int)launch_bf16<64>(q, k, v, o, lse, st, bh, q_len, kv_len,
                                causal, scale_log2, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch_f32<128>(q, k, v, o, lse, st, bh, q_len, kv_len,
                                causal, scale_log2, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch_f32<64>(q, k, v, o, lse, st, bh, q_len, kv_len,
                               causal, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}
