// Weight-only quantized matmul for decode rows, for Hopper (sm_90a).
//
// Replaces tiny_flash_attention_tpu/ops/quant_matmul.py::
// quantized_matmul_pallas (_kernel). out (M, N) = (x (M, K) @ w (K, N)) *
// scales (1, N): x in bf16 or f32, w int8 or float8 e4m3 (one byte per
// value, row-major, so a row of w is contiguous along N), scales f32 per
// output column. The payload converts exactly (every int8 and e4m3 value
// is a bf16 value, as in JAX's `w_ref[...].astype(x.dtype)`,
// quant_matmul.py:40-44), the products of x and the converted payload are
// exact in f32 and summed in f32, the scale multiplies the f32 sum and the
// result rounds once to x's dtype (quant.py:116-118). Every sum runs in an
// order fixed by the shape (deterministic).
//
// What bounds it: the weight's bytes. M is at most 16 rows (a decode
// batch), so the kernel does 2 * M operations per weight byte, far below
// the card's ridge; the least time is K * N bytes over the memory rate.
//
// bf16 x, the tensor-core design. At 8 rows the product needs 8 FMAs and
// one conversion per weight byte: on the CUDA cores (128 FMAs and 16
// int-to-float conversions a clock per SM) that alone takes about the
// bound, so the product runs on the tensor cores, as JAX's dot on the MXU:
// mma.sync m16n8k16 bf16 -> f32 with the operands swapped, out^T = w^T x^T:
// 16 output columns are the A operand's rows and the <= 8 decode rows the
// n = 8 of B, so the route's 8 rows fill the instruction (16 rows: two B
// tiles). wgmma is not needed: its 64-row minimum would waste 8x on x's
// side, and the product is bound by bytes.
//   - Tiles: a tile is TN = 128 output columns; a block of 4 warps owns a
//     slice of K and walks tiles (a persistent grid of at most the blocks
//     the card holds at once, so no tail wave). The weight streams through
//     a ring of STAGES stages of KT = 64 rows x 128 bytes in shared memory
//     by cp.async (16 bytes a thread; 8 where N is not a multiple of 16),
//     STAGES - 1 stages in flight while one is multiplied, across the
//     block's tiles. x is staged once per block for its whole K slice, in
//     bf16, by cp.async in the first stage's group (rows padded by 32
//     bytes so the B reads do not conflict); a K slice is a whole number
//     of stages but for the last.
//   - Fragments: warp w takes rows 16w..16w+15 of a stage across the 128
//     columns. A thread reads 4 rows x 16 bytes (row 4q + r, bytes 16g..,
//     q = lane % 4, g = lane / 4: a quarter-warp reads one whole 128-byte
//     row), which are the A fragments of 8 mma tiles: the k index of the
//     mma is a permutation of the 16 rows (k 2q, 2q+1, 2q+8, 2q+9 <-> rows
//     4q..4q+3) and x's B fragment takes the same permutation (one 8-byte
//     read of x[m][4q..4q+3]); tile j's rows g and g+8 are columns 16g + 2j
//     and 16g + 2j + 1. So no byte is moved twice and no read conflicts.
//   - Conversion without the slow conversion pipe, exactly: int8 by byte
//     permute into an f32 2^23 + (b + 128), a subtract, and the high halves
//     of two f32 as a bf16x2 (small integers are exact in bf16); e4m3
//     through the native e4m3x2 -> f16x2 convert and f32 (NaN stays NaN,
//     subnormals exact).
//   - Sums: the 4 warps' partial sums are added in warp order through
//     shared memory. Where N alone gives too few tiles (ops/configs.py::
//     quant_matmul_splits), K is split over the S blocks of a thread block
//     cluster (S <= 8) and the rank-0 block adds the S partial sums from
//     its peers' shared memory in rank order (distributed shared memory):
//     one launch, no atomics, no workspace.
// No converted copy of the weight is ever written.
//
// f32 x keeps the CUDA-core design: the tensor cores would round f32 x to
// TF32, and the f32 gate is 2e-5. A block of 256 threads owns 32 columns
// and a slice of K; a thread reads 8 consecutive weight bytes of a row with
// one 8-byte load and keeps M x 8 f32 sums; x is staged in shared memory as
// f32, 512 columns at a time; the k rows are summed by shuffles inside a
// warp, then across warps through shared memory; K splits over a cluster as
// above.

#include <cooperative_groups.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "flash_common.cuh"

#if !defined(TFA_QMM_BLOCK_M) || !defined(TFA_QMM_BLOCK_N) || \
    !defined(TFA_QMM_THREADS) || !defined(TFA_QMM_K_CHUNK) ||   \
    !defined(TFA_QMM_TC_BLOCK_N) || !defined(TFA_QMM_TC_THREADS) || \
    !defined(TFA_QMM_TC_K_STAGE) || !defined(TFA_QMM_TC_STAGES)
#error "the tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;
constexpr int MAX_SPLITS = 8;             // portable cluster size

// ------------------------------------------------ bf16 x, tensor cores

constexpr int TN = TFA_QMM_TC_BLOCK_N;      // output columns per tile
constexpr int TC_THREADS = TFA_QMM_TC_THREADS;
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int KT = TFA_QMM_TC_K_STAGE;      // weight rows per stage
constexpr int STAGES = TFA_QMM_TC_STAGES;
static_assert(TN == 128 && KT == 16 * TC_WARPS && STAGES >= 2,
              "a warp takes 16 rows of a stage across 128 columns");
constexpr int STAGE_BYTES = KT * TN;
constexpr int XPAD = 16;                    // bf16 pad of an x row

// 8-byte async copy (.ca: .cg takes 16 bytes only); src_bytes == 0
// zero-fills the destination.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const int n = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

// Four pairs of payload bytes -> four bf16x2: pair i holds (lo: byte i of
// a, hi: byte i of b), exactly.
template <typename W>
__device__ __forceinline__ void to_bf16x2(uint32_t a, uint32_t b,
                                          uint32_t (&pair)[4]);
template <>
__device__ __forceinline__ void to_bf16x2<int8_t>(uint32_t a, uint32_t b,
                                                  uint32_t (&pair)[4]) {
  // b + 128 as the low mantissa byte of 2^23: 2^23 + b + 128 exactly, less
  // 2^23 + 128; the f32's high half is then the bf16 (|b| <= 128)
  const uint32_t ua = a ^ 0x80808080u, ub = b ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float fa =
        __uint_as_float(__byte_perm(ua, 0x4B000000u, 0x7650 + i)) - 8388736.f;
    const float fb =
        __uint_as_float(__byte_perm(ub, 0x4B000000u, 0x7650 + i)) - 8388736.f;
    pair[i] = __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
  }
}
template <>
__device__ __forceinline__ void to_bf16x2<__nv_fp8_e4m3>(
    uint32_t a, uint32_t b, uint32_t (&pair)[4]) {
  // (a_i, b_i) as one e4m3x2, through f16x2 and f32: exact
  const uint32_t lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t e2[4] = {lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu, hi >> 16};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw h =
        __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)e2[i], __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    pair[i] = pack_bf16(f.x, f.y);
  }
}

// grid (tile walkers, S); block (x, s) sums the k rows [s * k_split,
// (s + 1) * k_split) of tiles x, x + gridDim.x, ...; with CLUSTER the S
// blocks of a walker form a cluster (1, S, 1) and its rank-0 block adds
// their sums. NT: B tiles of 8 rows (1: M <= 8, 2: M <= 16). V16: N is a
// multiple of 16 (16-byte weight copies).
template <typename W, int NT, bool CLUSTER, bool V16>
__global__ void __launch_bounds__(TC_THREADS)
    quant_matmul_tc_kernel(const bf16* __restrict__ x,
                           const uint8_t* __restrict__ w,
                           const float* __restrict__ scales,
                           bf16* __restrict__ out, int M, int K, int N,
                           int k_split, int xs_len) {
  constexpr int MT = 8 * NT;               // x rows in shared memory
  constexpr int ACC = 8 * NT * 4;          // f32 sums a thread
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* stages = smem;
  const int XS = xs_len + XPAD;            // bf16 per x row
  bf16* xs = reinterpret_cast<bf16*>(smem + STAGES * STAGE_BYTES);
  float* red = reinterpret_cast<float*>(xs + MT * XS);  // [WARPS-1][ACC][32]
  float* part = red + (TC_WARPS - 1) * ACC * 32;        // [ACC][32]

  const int tid = threadIdx.x, wp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int kb = blockIdx.y * k_split, ke = min(K, kb + k_split);
  const int n_st = (ke - kb + KT - 1) / KT;        // stages per tile
  const int n_tiles = (N + TN - 1) / TN;
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int total = my_tiles * n_st;

  auto load = [&](int f) {                 // flat stage f into its slot
    const int n0 = ((int)blockIdx.x + f / n_st * (int)gridDim.x) * TN;
    const int k0 = kb + f % n_st * KT;
    uint8_t* dst = stages + f % STAGES * STAGE_BYTES;
    constexpr int VB = V16 ? 16 : 8;
#pragma unroll
    for (int i = 0; i < STAGE_BYTES / VB / TC_THREADS; ++i) {
      const int c = tid + i * TC_THREADS;
      const int r = c / (TN / VB), col = c % (TN / VB) * VB;
      const bool ok = k0 + r < ke && n0 + col < N;
      const uint8_t* src = ok ? w + (size_t)(k0 + r) * N + n0 + col : w;
      if constexpr (V16) cp_async16(dst + r * TN + col, src, ok);
      else cp_async8(dst + r * TN + col, src, ok);
    }
  };

  // x's slice, once per block (zeros past M and past the slice): with the
  // first stage's copies where rows are 16-byte aligned
  const int ks = ke - kb;
  const bool x_async = K % 8 == 0 && k_split % 8 == 0;
  if (x_async) {
    for (int i = tid; i < MT * xs_len / 8; i += TC_THREADS) {
      const int m = i / (xs_len / 8), kk = i % (xs_len / 8) * 8;
      const bool ok = m < M && kk < ks;
      cp_async16(xs + m * XS + kk, ok ? x + (size_t)m * K + kb + kk : x, ok);
    }
  }
#pragma unroll
  for (int f = 0; f < STAGES - 1; ++f) {
    if (f < total) load(f);
    cp_async_commit();
  }
  if (!x_async) {
    for (int i = tid; i < MT * xs_len; i += TC_THREADS) {
      const int m = i / xs_len, kk = i % xs_len;
      xs[m * XS + kk] = (m < M && kk < ks) ? x[(size_t)m * K + kb + kk]
                                           : __float2bfloat16_rn(0.f);
    }
  }

  float acc[8][NT][4];
  float4 sc4[4];  // warp 0: the scales of columns 16g .. 16g + 15
  for (int f = 0; f < total; ++f) {
    if (f + STAGES - 1 < total) load(f + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // stage f (and x) landed for every thread
    const int s = f % n_st;
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][t][e] = 0.f;
      if (wp == 0) {  // the tile's scales, in flight during its products
        const int n = ((int)blockIdx.x + f / n_st * (int)gridDim.x) * TN +
                      16 * g;
#pragma unroll
        for (int h = 0; h < 4; ++h)
          sc4[h] = n + 4 * h < N
                       ? *reinterpret_cast<const float4*>(scales + n + 4 * h)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    const uint8_t* st =
        stages + f % STAGES * STAGE_BYTES + (wp * 16 + 4 * q) * TN + 16 * g;
    uint4 w4[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w4[r] = *reinterpret_cast<const uint4*>(st + r * TN);
    uint2 xb[NT];
    const bf16* xr = xs + g * XS + s * KT + wp * 16 + 4 * q;
#pragma unroll
    for (int t = 0; t < NT; ++t)
      xb[t] = *reinterpret_cast<const uint2*>(xr + t * 8 * XS);
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&w4[0]);
    const uint32_t* r1 = reinterpret_cast<const uint32_t*>(&w4[1]);
    const uint32_t* r2 = reinterpret_cast<const uint32_t*>(&w4[2]);
    const uint32_t* r3 = reinterpret_cast<const uint32_t*>(&w4[3]);
#pragma unroll
    for (int jw = 0; jw < 4; ++jw) {  // columns 16g + 4jw .. + 3
      uint32_t p01[4], p23[4];
      to_bf16x2<W>(r0[jw], r1[jw], p01);
      to_bf16x2<W>(r2[jw], r3[jw], p23);
#pragma unroll
      for (int u = 0; u < 2; ++u) {     // mma tile 2jw + u
        const uint32_t a[4] = {p01[2 * u], p01[2 * u + 1], p23[2 * u],
                               p23[2 * u + 1]};
#pragma unroll
        for (int t = 0; t < NT; ++t)
          mma_16816(acc[2 * jw + u][t], a, xb[t].x, xb[t].y);
      }
    }

    if (s == n_st - 1) {  // the tile's epilogue
      const int n0 = ((int)blockIdx.x + f / n_st * (int)gridDim.x) * TN;
      float* flat = &acc[0][0][0];
      // the warps' sums, in warp order
      if (wp > 0) {
#pragma unroll
        for (int e = 0; e < ACC; ++e)
          red[((wp - 1) * ACC + e) * 32 + lane] = flat[e];
      }
      __syncthreads();
      if (wp == 0) {
        for (int v = 1; v < TC_WARPS; ++v)
#pragma unroll
          for (int e = 0; e < ACC; ++e)
            flat[e] += red[((v - 1) * ACC + e) * 32 + lane];
      }
      bool writes = wp == 0;
      if constexpr (CLUSTER) {  // the K slices, in rank order, by rank 0
        cg::cluster_group cluster = cg::this_cluster();
        if (wp == 0) {
#pragma unroll
          for (int e = 0; e < ACC; ++e) part[e * 32 + lane] = flat[e];
        }
        cluster.sync();
        writes = writes && cluster.block_rank() == 0;
        if (writes) {
          // every peer's sums loaded at once, then added in rank order
          const int splits = (int)cluster.num_blocks();
#pragma unroll
          for (int e0 = 0; e0 < ACC; e0 += 8) {
            float got[MAX_SPLITS - 1][8];
#pragma unroll
            for (int r = 1; r < MAX_SPLITS; ++r)
              if (r < splits) {
                const float* peer = cluster.map_shared_rank(part, r);
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  got[r - 1][e] = peer[(e0 + e) * 32 + lane];
              }
#pragma unroll
            for (int r = 1; r < MAX_SPLITS; ++r)
              if (r < splits) {
#pragma unroll
                for (int e = 0; e < 8; ++e) flat[e0 + e] += got[r - 1][e];
              }
          }
        }
        cluster.sync();  // the peers' shared memory stays until read
      }
      if (writes) {
        // columns n0 + 16g + b: tile b / 2, row g (b even) or g + 8
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int mm = 0; mm < 2; ++mm) {
            const int m = t * 8 + 2 * q + mm;
            if (m >= M) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = n0 + 16 * g + 8 * h;
              if (n >= N) continue;  // N % 8 == 0: 8 columns in or out
              const float4 s0 = sc4[2 * h], s1 = sc4[2 * h + 1];
              const float sc[8] = {s0.x, s0.y, s0.z, s0.w,
                                   s1.x, s1.y, s1.z, s1.w};
              uint32_t o[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int j = 4 * h + i;  // the mma tile of columns 2i, 2i+1
                o[i] = pack_bf16(acc[j][t][mm] * sc[2 * i],
                                 acc[j][t][2 + mm] * sc[2 * i + 1]);
              }
              *reinterpret_cast<uint4*>(out + (size_t)m * N + n) =
                  make_uint4(o[0], o[1], o[2], o[3]);
            }
          }
      }
    }
    __syncthreads();  // this slot is read by no one before it is refilled
  }
}

// Blocks of `kernel` one SM holds at `smem` bytes, asked once per device
// and size.
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem) {
  constexpr int SLOTS = 8;
  static int key[kMaxDevices][SLOTS], val[kMaxDevices][SLOTS];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 1;
  for (int i = 0; i < SLOTS && key[dev][i]; ++i)
    if (key[dev][i] == smem) return val[dev][i];
  int blocks = 1, sms = 1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    TC_THREADS, smem) !=
      cudaSuccess)
    blocks = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n = max(1, blocks) * max(1, sms);
  for (int i = 0; i < SLOTS; ++i)
    if (!key[dev][i]) {
      key[dev][i] = smem;
      val[dev][i] = n;
      break;
    }
  return n;
}

template <typename W, int NT, bool CLUSTER, bool V16>
cudaError_t launch_tc_instance(int splits, int k_split, const void* x,
                               const void* w, const void* scales, void* out,
                               int M, int K, int N, cudaStream_t stream) {
  const auto kernel = quant_matmul_tc_kernel<W, NT, CLUSTER, V16>;
  const int xs_len = (k_split + KT - 1) / KT * KT;
  const int smem = STAGES * STAGE_BYTES + 8 * NT * (xs_len + XPAD) * 2 +
                   TC_WARPS * 8 * NT * 4 * 32 * 4;
  if (smem > 232448) return cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(kernel, 232448, smem_set);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + TN - 1) / TN;
  const int walkers =
      min(n_tiles, max(1, resident_blocks(kernel, smem) / splits));

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(walkers, splits);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(x),
                            static_cast<const uint8_t*>(w),
                            static_cast<const float*>(scales),
                            static_cast<bf16*>(out), M, K, N, k_split,
                            xs_len);
}

template <typename W, int NT>
cudaError_t launch_tc_rows(int splits, int k_split, const void* x,
                           const void* w, const void* scales, void* out,
                           int M, int K, int N, cudaStream_t stream) {
  const bool cluster = splits > 1, v16 = N % 16 == 0;
  const auto go = cluster ? (v16 ? launch_tc_instance<W, NT, true, true>
                                 : launch_tc_instance<W, NT, true, false>)
                          : (v16 ? launch_tc_instance<W, NT, false, true>
                                 : launch_tc_instance<W, NT, false, false>);
  return go(splits, k_split, x, w, scales, out, M, K, N, stream);
}

template <typename W>
cudaError_t launch_tc(int rows, int splits, const void* x, const void* w,
                      const void* scales, void* out, int M, int K, int N,
                      cudaStream_t stream) {
  // whole stages a slice, no empty slice
  const int k_split = ((K + splits - 1) / splits + KT - 1) / KT * KT;
  splits = (K + k_split - 1) / k_split;
  return rows <= 8 ? launch_tc_rows<W, 1>(splits, k_split, x, w, scales, out,
                                          M, K, N, stream)
                   : launch_tc_rows<W, 2>(splits, k_split, x, w, scales, out,
                                          M, K, N, stream);
}

// ------------------------------------------------------ f32 x, CUDA cores

constexpr int MAX_ROWS = TFA_QMM_BLOCK_M;
constexpr int FTN = TFA_QMM_BLOCK_N;      // output columns per block
constexpr int THREADS = TFA_QMM_THREADS;
constexpr int KC = TFA_QMM_K_CHUNK;       // x columns staged per step
constexpr int VEC = 8;                    // weight bytes per thread load
constexpr int CG = FTN / VEC;             // column groups per block
constexpr int KS = THREADS / CG;          // k slices per block
constexpr int WARPS = THREADS / 32;
static_assert(FTN % VEC == 0 && 32 % CG == 0 && THREADS % 32 == 0, "tile");
constexpr int X_FLOATS = MAX_ROWS * KC;
constexpr int RED_FLOATS = WARPS * MAX_ROWS * FTN;
constexpr int SMEM_FLOATS = X_FLOATS > RED_FLOATS ? X_FLOATS : RED_FLOATS;

// one payload byte -> its exact value
template <typename W>
__device__ __forceinline__ float w_to_f(uint8_t b);
template <>
__device__ __forceinline__ float w_to_f<int8_t>(uint8_t b) {
  return static_cast<float>(static_cast<int8_t>(b));
}
template <>
__device__ __forceinline__ float w_to_f<__nv_fp8_e4m3>(uint8_t b) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return static_cast<float>(v);
}

// grid (N / FTN, S): block (n, s) sums the k rows [s * k_split, (s + 1) *
// k_split) of its FTN columns; with CLUSTER the S blocks of a column tile
// form a cluster (1, S, 1) and its rank-0 block adds their sums
template <typename W, int MT, bool CLUSTER>
__global__ void __launch_bounds__(THREADS)
    quant_matmul_f32_kernel(const float* __restrict__ x,
                            const uint8_t* __restrict__ w,
                            const float* __restrict__ scales,
                            float* __restrict__ out, int M, int K, int N,
                            int k_split) {
  constexpr int RPT = KC / KS;  // weight rows a thread loads per chunk
  static_assert(KC % KS == 0, "chunk");
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  __shared__ float part[CLUSTER ? MT * FTN : 1];  // read by the rank-0 block
  float(*xs)[KC] = reinterpret_cast<float(*)[KC]>(smem);
  const int tid = threadIdx.x, grp = tid % CG, ks = tid / CG;
  const int n0 = blockIdx.x * FTN + grp * VEC;
  const bool live = n0 < N;  // N % 8 == 0: a group is wholly in or out
  const int kb = blockIdx.y * k_split, ke = min(K, kb + k_split);

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += KC) {
    const int kc = min(KC, ke - k0);
    // the chunk's weight rows first, so their loads are in flight while x
    // is staged
    uint2 wr[RPT];
    const uint8_t* wp = w + (size_t)k0 * N + n0;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int kk = ks + r * KS;
      wr[r] = (live && kk < kc)
                  ? __ldg(reinterpret_cast<const uint2*>(wp + (size_t)kk * N))
                  : make_uint2(0u, 0u);
    }
    __syncthreads();  // the previous chunk is read
    for (int i = tid; i < MT * KC; i += THREADS) {
      const int m = i / KC, kk = i % KC;
      xs[m][kk] = (m < M && kk < kc) ? x[(size_t)m * K + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int kk = ks + r * KS;
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&wr[r]);
      float wf[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) wf[v] = w_to_f<W>(b[v]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m][kk];  // 0 past the chunk: w is 0 there too
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[m][v] = fmaf(xv, wf[v], acc[m][v]);
      }
    }
  }

  // the k rows of a warp (lane = row slice * CG + group) ...
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int o = CG; o < 32; o <<= 1)
        acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], o);
  // ... then the warps, through shared memory
  __syncthreads();  // every thread is done with xs
  float(*red)[MT][FTN] = reinterpret_cast<float(*)[MT][FTN]>(smem);
  const int warp = tid / 32, lane = tid % 32;
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[warp][m][lane * VEC + v] = acc[m][v];
  }
  __syncthreads();
  if constexpr (!CLUSTER) {
    for (int i = tid; i < M * FTN; i += THREADS) {
      const int n = blockIdx.x * FTN + i % FTN;
      if (n >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[wi][i / FTN][i % FTN];
      out[(size_t)(i / FTN) * N + n] = s * scales[n];
    }
  } else {
    for (int i = tid; i < M * FTN; i += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[wi][i / FTN][i % FTN];
      part[i] = s;
    }
    // ... then the cluster's K slices, in rank order, by the rank-0 block
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      const int splits = (int)cluster.num_blocks();
      for (int i = tid; i < M * FTN; i += THREADS) {
        const int n = blockIdx.x * FTN + i % FTN;
        if (n >= N) continue;
        float s = 0.f;
        for (int r = 0; r < splits; ++r)
          s += cluster.map_shared_rank(part, r)[i];
        out[(size_t)(i / FTN) * N + n] = s * scales[n];
      }
    }
    cluster.sync();  // the peers' shared memory stays until rank 0 read it
  }
}

template <typename W>
cudaError_t launch_f32(int rows, int splits, const void* x, const void* w,
                       const void* scales, void* out, int M, int K, int N,
                       cudaStream_t stream) {
  const int nb = (N + FTN - 1) / FTN;
  const int k_split = (K + splits - 1) / splits;
  splits = (K + k_split - 1) / k_split;  // no empty slice

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const float* xp = static_cast<const float*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
#define TFA_QMM_LAUNCH(MT)                                                  \
  return splits > 1                                                         \
             ? cudaLaunchKernelEx(&cfg, quant_matmul_f32_kernel<W, MT, true>, \
                                  xp, wp, sp, op, M, K, N, k_split)         \
             : cudaLaunchKernelEx(&cfg,                                     \
                                  quant_matmul_f32_kernel<W, MT, false>,    \
                                  xp, wp, sp, op, M, K, N, k_split)
  switch (rows) {
    case 1: TFA_QMM_LAUNCH(1);
    case 2: TFA_QMM_LAUNCH(2);
    case 4: TFA_QMM_LAUNCH(4);
    case 8: TFA_QMM_LAUNCH(8);
    case 16: TFA_QMM_LAUNCH(16);
    default: return cudaErrorInvalidValue;
  }
#undef TFA_QMM_LAUNCH
}

}  // namespace

static_assert(MAX_ROWS == 16, "the row buckets below stop at 16");

// Returns a cudaError_t: 0 when the kernel was launched. dtypes: x (0 bf16,
// 1 f32) * 2 + w (0 int8, 1 e4m3). rows: the bucket (1, 2, 4, 8 or 16) with
// M <= rows. splits: the K slices (1 to 8; the blocks of a cluster). The
// caller has checked shapes (N % 8 == 0), contiguity and 16-byte alignment.
extern "C" int tfa_quant_matmul(const void* x, const void* w,
                                const void* scales, void* out, int M, int K,
                                int N, int dtypes, int rows, int splits,
                                void* stream) {
  if (M < 1 || M > rows || rows > MAX_ROWS || K < 1 || N < 8 || N % 8 ||
      splits < 1 || splits > MAX_SPLITS || splits > K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0:
      return (int)launch_tc<int8_t>(rows, splits, x, w, scales, out, M, K,
                                    N, s);
    case 1:
      return (int)launch_tc<__nv_fp8_e4m3>(rows, splits, x, w, scales, out,
                                           M, K, N, s);
    case 2:
      return (int)launch_f32<int8_t>(rows, splits, x, w, scales, out, M, K,
                                     N, s);
    case 3:
      return (int)launch_f32<__nv_fp8_e4m3>(rows, splits, x, w, scales, out,
                                            M, K, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The bf16 x instances' payload conversion, for a test of every code:
// out[c] is code c converted as the low half of a pair, out[256 + c] as the
// high half (the permutes place the two bytes of a pair differently).
__global__ void convert_codes_kernel(int e4m3, bf16* out) {
  const int i = threadIdx.x;  // 64 threads x 4 codes
  const uint32_t a = (uint32_t)(4 * i) | (uint32_t)(4 * i + 1) << 8 |
                     (uint32_t)(4 * i + 2) << 16 | (uint32_t)(4 * i + 3) << 24;
  const uint32_t b = a ^ 0x80808080u;
  uint32_t pair[4];
  if (e4m3)
    to_bf16x2<__nv_fp8_e4m3>(a, b, pair);
  else
    to_bf16x2<int8_t>(a, b, pair);
  for (int j = 0; j < 4; ++j) {
    out[4 * i + j] = __ushort_as_bfloat16((unsigned short)(pair[j] & 0xFFFFu));
    out[256 + ((4 * i + j) ^ 0x80)] =
        __ushort_as_bfloat16((unsigned short)(pair[j] >> 16));
  }
}

// Returns a cudaError_t: 0 when the conversion test kernel was launched
// (out: 512 bf16; e4m3 0 converts int8 codes, 1 e4m3 codes).
extern "C" int tfa_quant_convert_codes(int e4m3, void* out, void* stream) {
  convert_codes_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      e4m3, static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}
