// Weight-only quantized matmul for decode rows, for Hopper (sm_90a).
//
// Replaces tiny_flash_attention_tpu/ops/quant_matmul.py::
// quantized_matmul_pallas (_kernel). out (M, N) = (x (M, K) @ w (K, N)) *
// scales (1, N): x in bf16 or f32, w int8 or float8 e4m3 (one byte per
// value, row-major, so a row of w is contiguous along N), scales f32 per
// output column. The payload converts exactly to f32 (int8 -> float; e4m3
// -> float through the native convert, exact like JAX's plain astype of the
// weight, quant.py:116), the products of x and the converted payload are
// exact in f32 and summed in f32, the scale multiplies the f32 sum and the
// result rounds once to x's dtype (quant.py:116-118).
//
// What bounds it: the weight's bytes. M is at most 16 rows (a decode batch),
// so the kernel does 2 * M operations per weight byte, far below the card's
// ridge; the least time is K * N bytes over the memory rate. The design: a
// block owns TN output columns and a slice of K, so each weight byte is read
// once. Its threads split the slice (KS rows at a time) and the columns (CG
// groups of 8): a thread reads 8 consecutive weight bytes of a row with one
// 8-byte load (a warp covers 8 rows x TN bytes per step, 32-byte sectors
// whole) and keeps M x 8 f32 sums. x is staged in shared memory as f32, KC
// columns at a time, and read as a broadcast. The k rows are summed by
// shuffles inside a warp, then across warps through shared memory. Where N
// alone gives too few blocks to keep the card's loads in flight (the 1024-
// and 256-column projections), K is split over the S blocks of a thread
// block cluster (S <= 8, chosen by the caller, ops/configs.py);
// the cluster's rank-0 block adds the S partial sums from its peers' shared
// memory (Hopper's distributed shared memory), so there is one launch, no
// atomics and no workspace, and every sum runs in a fixed order
// (deterministic). A thread issues its weight loads of a chunk before the
// chunk's x is staged, so the two latencies overlap. No converted copy of
// the weight is ever written.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#if !defined(TFA_QMM_BLOCK_M) || !defined(TFA_QMM_BLOCK_N) || \
    !defined(TFA_QMM_THREADS) || !defined(TFA_QMM_K_CHUNK)
#error "the tile sizes are passed by the build (ops/configs.py)"
#endif

namespace {

constexpr int MAX_ROWS = TFA_QMM_BLOCK_M;
constexpr int TN = TFA_QMM_BLOCK_N;       // output columns per block
constexpr int THREADS = TFA_QMM_THREADS;
constexpr int KC = TFA_QMM_K_CHUNK;       // x columns staged per step
constexpr int VEC = 8;                    // weight bytes per thread load
constexpr int CG = TN / VEC;              // column groups per block
constexpr int KS = THREADS / CG;          // k slices per block
constexpr int WARPS = THREADS / 32;
static_assert(TN % VEC == 0 && 32 % CG == 0 && THREADS % 32 == 0, "tile");
constexpr int X_FLOATS = MAX_ROWS * KC;
constexpr int RED_FLOATS = WARPS * MAX_ROWS * TN;
constexpr int SMEM_FLOATS = X_FLOATS > RED_FLOATS ? X_FLOATS : RED_FLOATS;
constexpr int MAX_SPLITS = 8;             // portable cluster size

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

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

// grid (N / TN, S): block (n, s) sums the k rows [s * k_split, (s + 1) *
// k_split) of its TN columns; with CLUSTER the S blocks of a column tile
// form a cluster (1, S, 1) and its rank-0 block adds their sums
template <typename X, typename W, int MT, bool CLUSTER>
__global__ void __launch_bounds__(THREADS)
    quant_matmul_kernel(const X* __restrict__ x,
                        const uint8_t* __restrict__ w,
                        const float* __restrict__ scales,
                        X* __restrict__ out, int M, int K, int N,
                        int k_split) {
  constexpr int RPT = KC / KS;  // weight rows a thread loads per chunk
  static_assert(KC % KS == 0, "chunk");
  __shared__ __align__(16) float smem[SMEM_FLOATS];
  __shared__ float part[CLUSTER ? MT * TN : 1];  // read by the rank-0 block
  float(*xs)[KC] = reinterpret_cast<float(*)[KC]>(smem);
  const int tid = threadIdx.x, grp = tid % CG, ks = tid / CG;
  const int n0 = blockIdx.x * TN + grp * VEC;
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
      xs[m][kk] =
          (m < M && kk < kc) ? to_f(x[(size_t)m * K + k0 + kk]) : 0.f;
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
  float(*red)[MT][TN] = reinterpret_cast<float(*)[MT][TN]>(smem);
  const int warp = tid / 32, lane = tid % 32;
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[warp][m][lane * VEC + v] = acc[m][v];
  }
  __syncthreads();
  if constexpr (!CLUSTER) {
    for (int i = tid; i < M * TN; i += THREADS) {
      const int n = blockIdx.x * TN + i % TN;
      if (n >= N) continue;
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[wi][i / TN][i % TN];
      out[(size_t)(i / TN) * N + n] = from_f<X>(s * scales[n]);
    }
  } else {
    for (int i = tid; i < M * TN; i += THREADS) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[wi][i / TN][i % TN];
      part[i] = s;
    }
    // ... then the cluster's K slices, in rank order, by the rank-0 block
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      const int splits = (int)cluster.num_blocks();
      for (int i = tid; i < M * TN; i += THREADS) {
        const int n = blockIdx.x * TN + i % TN;
        if (n >= N) continue;
        float s = 0.f;
        for (int r = 0; r < splits; ++r)
          s += cluster.map_shared_rank(part, r)[i];
        out[(size_t)(i / TN) * N + n] = from_f<X>(s * scales[n]);
      }
    }
    cluster.sync();  // the peers' shared memory stays until rank 0 read it
  }
}

template <typename X, typename W>
cudaError_t launch_rows(int rows, int splits, const void* x, const void* w,
                        const void* scales, void* out, int M, int K, int N,
                        cudaStream_t stream) {
  const int nb = (N + TN - 1) / TN;
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
  const X* xp = static_cast<const X*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  X* op = static_cast<X*>(out);
#define TFA_QMM_LAUNCH(MT)                                                  \
  return splits > 1                                                         \
             ? cudaLaunchKernelEx(&cfg, quant_matmul_kernel<X, W, MT, true>, \
                                  xp, wp, sp, op, M, K, N, k_split)         \
             : cudaLaunchKernelEx(&cfg,                                     \
                                  quant_matmul_kernel<X, W, MT, false>, xp, \
                                  wp, sp, op, M, K, N, k_split)
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
// caller has checked shapes (N % 8 == 0), contiguity and alignment.
extern "C" int tfa_quant_matmul(const void* x, const void* w,
                                const void* scales, void* out, int M, int K,
                                int N, int dtypes, int rows, int splits,
                                void* stream) {
  if (M < 1 || M > rows || K < 1 || N < 8 || N % 8 || splits < 1 ||
      splits > MAX_SPLITS || splits > K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtypes) {
    case 0:
      return (int)launch_rows<__nv_bfloat16, int8_t>(
          rows, splits, x, w, scales, out, M, K, N, s);
    case 1:
      return (int)launch_rows<__nv_bfloat16, __nv_fp8_e4m3>(
          rows, splits, x, w, scales, out, M, K, N, s);
    case 2:
      return (int)launch_rows<float, int8_t>(rows, splits, x, w, scales, out,
                                             M, K, N, s);
    case 3:
      return (int)launch_rows<float, __nv_fp8_e4m3>(
          rows, splits, x, w, scales, out, M, K, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
