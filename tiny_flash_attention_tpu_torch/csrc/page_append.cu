// In-place append of one token per (kv head, sequence) into fused KV pages,
// for Hopper (sm_90a).
//
// Replaces tiny_flash_attention_tpu/ops/paged_fused.py::fused_page_append
// (_append_kernel), which never compiled on the TPU (the JAX engine runs an
// XLA scatter instead, models/inference.py:233-276). pages (hkv, num_pages,
// page_rows, D); k_new, v_new (B, hkv, D); page_ids, rows (B,) int32: token
// b goes to row rows[b] of page page_ids[b]. Float pages take the K row at
// page row `row` and the V row at page_size + row, converted to the page
// dtype (round to nearest even, as torch and XLA convert). int8 pages take
// each row quantized as the JAX package does it (kv_cache.py:254-260):
// amax = max |x| in f32, scale = amax == 0 ? 1 : amax / 127 (IEEE
// division, no fast math), q = clamp(rint(x / scale), -127, 127) (round half
// to even, as jnp.round and torch.round); the f32 scale's 4 little-endian
// bytes go to rows 2ps + 4 * (row / D) + j (K) and that + sr (V), lane
// row % D (kv_cache.py:301-309).
//
// What bounds it: nothing on the card; it moves 2 * B * hkv rows of D
// values. One warp per (kv head, sequence) converts and stores its two
// rows (each lane D / 32 contiguous values at head_dim 64, 128, 256 and
// 512, else the ceil(D / 32) values lane, lane + 32, ... below D: head_dim
// 80 and 96, every other head_dim up to 256 on one instance that reads D
// at run time, 8 values a lane at most, and every other head_dim in (256,
// 512) on a second one, 16 a lane; the amax is a warp reduction), so the
// whole append of a layer is one launch where the
// scatter decomposition takes 2 payload scatters, 8 single-byte scale
// scatters and the quantize ops. A target outside the pages array is
// skipped: the engine never makes one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kInt8Max = 127.f;

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

// S: dtype of k_new / v_new; P: page element type (bf16, f32 or int8_t); D:
// the head_dim, or 0 for the instances that take head_dim at run time, up
// to 32 * EMAX (EMAX values a lane)
template <typename S, typename P, int D, int EMAX = 8>
__global__ void __launch_bounds__(32)
    page_append_kernel(const S* __restrict__ k_new,
                       const S* __restrict__ v_new,
                       const int* __restrict__ page_ids,
                       const int* __restrict__ rows, P* __restrict__ pages,
                       int hkv, int num_pages, int page_rows, int page_size,
                       int head_dim) {
  constexpr bool STRIDED = D % 64 != 0 || D == 0;
  constexpr int E = D > 0 ? (D + 31) / 32 : EMAX;
  const int d = D > 0 ? D : head_dim;
  const int h = blockIdx.x, b = blockIdx.y, lane = threadIdx.x;
  // the lane's value e: at off(e) past its first column, live below d (at
  // head_dim 64, 128, 256 and 512 every value, known at compile time)
  auto off = [&](int e) { return STRIDED ? 32 * e : e; };
  auto live = [&](int e) { return !STRIDED || lane + 32 * e < d; };
  const int pid = page_ids[b], row = rows[b];
  if (pid < 0 || pid >= num_pages || row < 0 || row >= page_size) return;
  P* page = pages + ((size_t)h * num_pages + pid) * page_rows * d;
  const int sr = (page_rows - 2 * page_size) / 2;  // scale rows per side
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int first = STRIDED ? lane : lane * E;
    const S* src = (side ? v_new : k_new) + ((size_t)b * hkv + h) * d + first;
    float x[E];
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] = live(e) ? to_f(src[off(e)]) : 0.f;
    P* dst = page + (size_t)(side * page_size + row) * d + first;
    if constexpr (sizeof(P) == 1) {
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, w));
      const float scale = amax == 0.f ? 1.f : __fdiv_rn(amax, kInt8Max);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float r = rintf(__fdiv_rn(x[e], scale));
        if (live(e))
          dst[off(e)] = (P)(int)fminf(fmaxf(r, -kInt8Max), kInt8Max);
      }
      if (lane < 4) {
        const uint32_t bits = __float_as_uint(scale);
        const int srow = 2 * page_size + side * sr + 4 * (row / d) + lane;
        page[(size_t)srow * d + row % d] = (P)(int8_t)(bits >> (8 * lane));
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (live(e)) dst[off(e)] = from_f<P>(x[e]);
    }
  }
}

template <typename S, typename P>
cudaError_t launch(int head_dim, const void* k_new, const void* v_new,
                   const void* page_ids, const void* rows, void* pages,
                   int batch, int hkv, int num_pages, int page_rows,
                   int page_size, cudaStream_t stream) {
  const dim3 grid(hkv, batch);
#define TFA_APPEND_LAUNCH(...)                                              \
  page_append_kernel<S, P, __VA_ARGS__><<<grid, 32, 0, stream>>>(           \
      static_cast<const S*>(k_new), static_cast<const S*>(v_new),           \
      static_cast<const int*>(page_ids), static_cast<const int*>(rows),     \
      static_cast<P*>(pages), hkv, num_pages, page_rows, page_size, head_dim)
  if (head_dim == 128) {
    TFA_APPEND_LAUNCH(128);
  } else if (head_dim == 256) {
    TFA_APPEND_LAUNCH(256);
  } else if (head_dim == 64) {
    TFA_APPEND_LAUNCH(64);
  } else if (head_dim == 96) {
    TFA_APPEND_LAUNCH(96);
  } else if (head_dim == 80) {
    TFA_APPEND_LAUNCH(80);
  } else if (head_dim >= 1 && head_dim <= 256) {
    TFA_APPEND_LAUNCH(0);
  } else if (head_dim == 512) {
    TFA_APPEND_LAUNCH(512);
  } else if (head_dim > 256 && head_dim < 512) {
    TFA_APPEND_LAUNCH(0, 16);
  } else {
    return cudaErrorInvalidValue;
  }
#undef TFA_APPEND_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. src_dtype (k_new,
// v_new): 0 bf16, 1 f32. page_dtype: 0 bf16, 1 f32, 2 int8 (then page_rows
// = 2 * page_size + 2 * sr). head_dim: any in [1, 512] (64, 80, 96, 128,
// 256 and 512 on instances of their own). The caller has checked shapes,
// contiguity and alignment.
extern "C" int tfa_page_append(const void* k_new, const void* v_new,
                               const void* page_ids, const void* rows,
                               void* pages, int batch, int hkv,
                               int num_pages, int page_rows, int page_size,
                               int head_dim, int src_dtype, int page_dtype,
                               void* stream) {
  if (batch <= 0 || hkv <= 0 || page_size <= 0 || num_pages <= 0 ||
      (page_dtype == 2 ? page_rows <= 2 * page_size
                       : page_rows != 2 * page_size))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFA_APPEND_ARGS                                                     \
  head_dim, k_new, v_new, page_ids, rows, pages, batch, hkv, num_pages,    \
      page_rows, page_size, s
  switch (src_dtype * 3 + page_dtype) {
    case 0: return (int)launch<__nv_bfloat16, __nv_bfloat16>(TFA_APPEND_ARGS);
    case 1: return (int)launch<__nv_bfloat16, float>(TFA_APPEND_ARGS);
    case 2: return (int)launch<__nv_bfloat16, int8_t>(TFA_APPEND_ARGS);
    case 3: return (int)launch<float, __nv_bfloat16>(TFA_APPEND_ARGS);
    case 4: return (int)launch<float, float>(TFA_APPEND_ARGS);
    case 5: return (int)launch<float, int8_t>(TFA_APPEND_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TFA_APPEND_ARGS
}
