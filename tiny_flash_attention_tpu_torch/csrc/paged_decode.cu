// One-token GQA decode attention over fused KV pages, for Hopper (sm_90a).
//
// Replaces tiny_flash_attention_tpu/ops/paged_fused.py::
// fused_paged_decode_attention (_fused_decode_kernel) for bf16 (and f32)
// pages and for int8 pages with bit-packed f32 scale rows. A page holds K in
// rows [0, ps) and V in rows [ps, 2ps) of a (hkv, num_pages, page_rows, D)
// array; an int8 page adds sr = scale_rows_per_side(ps, D) rows of K scales
// and then sr rows of V scales, byte j of token i's f32 scale at row
// 2ps + 4 * (i / D) + j (V: + sr), lane i % D (paged_fused.py:86-103).
// page_indices (B, P) maps a sequence's logical page to a physical one.
// Returns out (B, hq, D) in q's dtype and a natural-log LSE (B, hq) in f32.
//
// What bounds it: the KV bytes. Each (sequence, kv head) reads
// 2 * length * D page elements once (int8: one byte each, plus 8 scale
// bytes per token) and does 4 * group * D FLOPs per token, two orders of
// magnitude below the card's operations-per-byte ridge. The design: one
// block per (kv head, sequence) serves the group's q rows, so every KV byte
// is read once per kv head; the block's 8 warps split the sequence into
// 32-token chunks (warp w takes chunks w, w + 8, ...) to keep many loads in
// flight. In a chunk each lane scores its own token with 16-byte row loads
// (q sits in shared memory, read as a broadcast), the warp updates its online
// softmax, and then each lane accumulates a D/32 slice of P V with coalesced
// V row loads. The warps' states merge once, at the end, with the exact LSE
// combine. Softmax runs in the log2 domain with sm_scale * log2(e) folded into
// q in the input dtype, P is rounded to the input dtype before the PV
// product, the mask value is -0.7 * FLT_MAX, m starts at -inf and an empty or
// NaN l is guarded (paged_fused.py:346, :443), all as the TPU kernel does.
// int8 pages keep the TPU kernel's rounding points (paged_fused.py:389-436):
// the payload converts exactly, the f32 score is multiplied by the token's K
// scale, l sums the unscaled p, and p times the token's V scale (in f32) is
// what rounds to q's dtype before the PV product. A lane assembles its
// token's two scales from their 4 bytes each while scoring.
//
// The attended length is min(lengths[b], P * ps): the kernel never reads a
// page id past the table width. page_indices may be a column slice of a wider
// table: its row stride is an argument.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#if !defined(TFA_DECODE_WARPS)
#error "the warp count is passed by the build (ops/configs.py)"
#endif

namespace {

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLn2 = 0.69314718055994530942f;
constexpr int WARPS = TFA_DECODE_WARPS;
constexpr int CHUNK = 32;  // tokens per warp step: one per lane when scoring

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

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

// one lane's slice of a V row, loaded as a single vector
template <typename T, int E>
struct alignas(sizeof(T) * E) Lane {
  T v[E];
};

// rounds to the input dtype and back (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// the f32 scale of token row r of a page, from its 4 bytes at rows
// first_row + 4 * (r / D) + j, lane r % D
template <int D>
__device__ __forceinline__ float page_scale(const int8_t* page, int first_row,
                                            int r) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(page) +
                     (size_t)(first_row + 4 * (r / D)) * D + r % D;
  const uint32_t bits = (uint32_t)p[0] | (uint32_t)p[D] << 8 |
                        (uint32_t)p[2 * D] << 16 | (uint32_t)p[3 * D] << 24;
  return __uint_as_float(bits);
}

// T: q and out dtype; P: page element type (T, or int8_t for int8 pages)
template <typename T, typename P, int D, int G>
__global__ void __launch_bounds__(WARPS * 32)
    paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ pages,
                        const int* __restrict__ lengths,
                        const int* __restrict__ page_indices, int pi_stride,
                        int pages_per_seq, T* __restrict__ out,
                        float* __restrict__ lse, int hkv, int num_pages,
                        int page_size, int page_rows, float scale_log2) {
  constexpr bool QUANT = sizeof(P) == 1;
  constexpr int E = D / 32;            // output elements per lane
  constexpr int VEC = 16 / sizeof(P);  // page elements per 16-byte load
  static_assert(D % 32 == 0 && D % VEC == 0, "head_dim");
  __shared__ __align__(16) float qs[G][D];
  __shared__ float red_m[WARPS][G];
  __shared__ float red_l[WARPS][G];
  __shared__ float red_acc[WARPS][G][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hq = hkv * G;
  const float qscale = round_to<T>(scale_log2);
  for (int i = tid; i < G * D; i += WARPS * 32)
    qs[i / D][i % D] =
        round_to<T>(to_f(q[((size_t)b * hq + h * G) * D + i]) * qscale);
  __syncthreads();

  const int n = max(0, min(lengths[b], pages_per_seq * page_size));
  const int* pt = page_indices + (size_t)b * pi_stride;
  const size_t page_elems = (size_t)page_rows * D;
  const P* head_pages = pages + (size_t)h * num_pages * page_elems;
  const int sr = (page_rows - 2 * page_size) / 2;  // scale rows per side

  float m_run[G], l_run[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;  // per-lane partial, warp-reduced at the end
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int base = warp * CHUNK; base < n; base += WARPS * CHUNK) {
    // scores: lane `lane` takes token base + lane
    const int t = base + lane;
    float s[G];
    float vscale = 1.f;
    if (t < n) {
      const P* page = head_pages + (size_t)pt[t / page_size] * page_elems;
      const int r = t % page_size;
      const P* krow = page + (size_t)r * D;
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
        const P* kv = reinterpret_cast<const P*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float kf = to_f(kv[i]);
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] = fmaf(qs[g][d0 + i], kf, s[g]);
        }
      }
      if constexpr (QUANT) {
        const int8_t* pb = reinterpret_cast<const int8_t*>(page);
        const float kscale = page_scale<D>(pb, 2 * page_size, r);
        vscale = page_scale<D>(pb, 2 * page_size + sr, r);
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] *= kscale;
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = kMaskValue;
    }

    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[g];
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      mx = fmaxf(mx, m_run[g]);
      const float alpha = exp2f(m_run[g] - mx);
      const float keep = mx > 0.5f * kMaskValue ? 1.f : 0.f;
      const float pf = exp2f(s[g] - mx) * keep;
      l_run[g] = alpha * l_run[g] + pf;
      p[g] = round_to<T>(QUANT ? pf * vscale : pf);
      m_run[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }

    // P V: lane `lane` owns output columns [lane * E, lane * E + E)
    const int cnt = min(CHUNK, n - base);
#pragma unroll 4
    for (int tt = 0; tt < cnt; ++tt) {
      const int tok = base + tt;
      const P* vrow = head_pages + (size_t)pt[tok / page_size] * page_elems +
                      (size_t)(page_size + tok % page_size) * D + lane * E;
      const Lane<P, E> vl = *reinterpret_cast<const Lane<P, E>*>(vrow);
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vf[e] = to_f(vl.v[e]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pt_g = __shfl_sync(0xffffffffu, p[g], tt);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pt_g, vf[e], acc[g][e]);
      }
    }
  }

  // merge the warps' (m, l, acc) with the exact LSE combine
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float l = l_run[g];
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(0xffffffffu, l, w);
    if (lane == 0) {
      red_m[warp][g] = m_run[g];
      red_l[warp][g] = l;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) red_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += WARPS * 32) {
    const int g = i / D, d = i % D;
    float m_f = -INFINITY;
    for (int w = 0; w < WARPS; ++w) m_f = fmaxf(m_f, red_m[w][g]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      // a warp that saw no token keeps m = -inf and weighs nothing
      const float wt =
          red_m[w][g] == -INFINITY ? 0.f : exp2f(red_m[w][g] - m_f);
      num += red_acc[w][g][d] * wt;
      den += red_l[w][g] * wt;
    }
    const float l_safe = (den == 0.f || den != den) ? 1.f : den;
    const size_t row = (size_t)b * hq + h * G + g;
    out[row * D + d] = from_f<T>(num / l_safe);
    if (d == 0)
      lse[row] = (m_f == -INFINITY ? kMaskValue : m_f) * kLn2 + logf(l_safe);
  }
}

template <typename T, typename P, int D>
cudaError_t launch_group(int group, const void* q, const void* pages,
                         const void* lengths, const void* page_indices,
                         int pi_stride, int pages_per_seq, void* out,
                         void* lse, int batch, int hkv, int num_pages,
                         int page_size, int page_rows, float scale_log2,
                         cudaStream_t stream) {
  const dim3 grid(hkv, batch);
#define TFA_DECODE_LAUNCH(G)                                               \
  paged_decode_kernel<T, P, D, G><<<grid, WARPS * 32, 0, stream>>>(        \
      static_cast<const T*>(q), static_cast<const P*>(pages),              \
      static_cast<const int*>(lengths),                                    \
      static_cast<const int*>(page_indices), pi_stride, pages_per_seq,     \
      static_cast<T*>(out), static_cast<float*>(lse), hkv, num_pages,      \
      page_size, page_rows, scale_log2)
  switch (group) {
    case 1: TFA_DECODE_LAUNCH(1); break;
    case 2: TFA_DECODE_LAUNCH(2); break;
    case 4: TFA_DECODE_LAUNCH(4); break;
    case 8: TFA_DECODE_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef TFA_DECODE_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 when the kernel was launched. dtype (of q and
// out): 0 bf16, 1 f32; quantized: 0 pages of q's dtype with page_rows =
// 2 * page_size, 1 int8 pages with page_rows = 2 * page_size + 2 * sr.
// head_dim: 64 or 128; group (hq / hkv): 1, 2, 4 or 8. The caller has
// checked shapes, contiguity and alignment.
extern "C" int tfa_paged_decode(const void* q, const void* pages,
                                const void* lengths, const void* page_indices,
                                int pi_stride, int pages_per_seq, void* out,
                                void* lse, int batch, int hq, int hkv,
                                int num_pages, int page_size, int page_rows,
                                int head_dim, float scale_log2, int dtype,
                                int quantized, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || page_size <= 0 ||
      pages_per_seq <= 0 ||
      (quantized ? page_rows <= 2 * page_size : page_rows != 2 * page_size))
    return (int)cudaErrorInvalidValue;
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TFA_DECODE_ARGS                                                     \
  group, q, pages, lengths, page_indices, pi_stride, pages_per_seq, out,   \
      lse, batch, hkv, num_pages, page_size, page_rows, scale_log2, s
#define TFA_DECODE_DISPATCH(T, P)                                           \
  if (head_dim == 128) return (int)launch_group<T, P, 128>(TFA_DECODE_ARGS); \
  if (head_dim == 64) return (int)launch_group<T, P, 64>(TFA_DECODE_ARGS);   \
  return (int)cudaErrorInvalidValue
  if (dtype == 0 && !quantized) {
    TFA_DECODE_DISPATCH(__nv_bfloat16, __nv_bfloat16);
  }
  if (dtype == 0 && quantized) {
    TFA_DECODE_DISPATCH(__nv_bfloat16, int8_t);
  }
  if (dtype == 1 && !quantized) {
    TFA_DECODE_DISPATCH(float, float);
  }
  if (dtype == 1 && quantized) {
    TFA_DECODE_DISPATCH(float, int8_t);
  }
#undef TFA_DECODE_DISPATCH
#undef TFA_DECODE_ARGS
  return (int)cudaErrorInvalidValue;
}
