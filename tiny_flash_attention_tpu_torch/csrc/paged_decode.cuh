// One-token GQA decode attention over a paged KV cache, for Hopper (sm_90a):
// the kernel template behind csrc/paged_decode.cu (fused pages, B4) and
// csrc/paged_decode_separate.cu (separate K and V page arrays, B12). The page
// layout is a template parameter; everything else is one design.
//
// page_indices (B, P) maps a sequence's logical page to a physical one.
// Returns out (B, hq, D) in q's dtype and a natural-log LSE (B, hq) in f32.
//
// What bounds it: the KV bytes. Each (sequence, kv head) reads
// 2 * length * D page elements once (int8: one byte each, plus 8 scale
// bytes per token) and does 4 * group * D FLOPs per token, two orders of
// magnitude below the card's operations-per-byte ridge. The design: one
// block per (kv head, sequence) serves the group's q rows, so every KV byte
// is read once per kv head; the block's 8 warps split the tokens into
// 32-token chunks (warp w takes chunks w, w + 8, ...) to keep many loads in
// flight. In a chunk each lane scores its own token with 16-byte row loads
// (q sits in shared memory, read as a broadcast), the warp updates its online
// softmax, and then each lane accumulates a D/32 slice of P V with coalesced
// V row loads. The warps' states merge once, at the end, with the exact LSE
// combine. Softmax runs in the log2 domain with sm_scale * log2(e) folded into
// q in the input dtype, P is rounded to the input dtype before the PV
// product, the mask value is -0.7 * FLT_MAX, m starts at -inf and an empty or
// NaN l is guarded (paged_fused.py:346, :443), all as the TPU kernels do.
// int8 pages keep the TPU kernels' rounding points (paged_fused.py:389-436,
// paged.py:176-210): the payload converts exactly, the f32 score is
// multiplied by the token's K scale, l sums the unscaled p, and p times the
// token's V scale (in f32) is what rounds to q's dtype before the PV product.
//
// Without a window the attended tokens are [0, min(lengths[b], P * ps)): the
// kernel never reads a page id past the table width. With a window (RING)
// they are [max(0, length - window), length), not clamped, and token t lies
// on logical page (t / ps) % P: the table is a ring of P pages that holds the
// last window of tokens for an unbounded generation, and the walk costs
// O(window), not O(length) (the ring mode of paged_fused.py:316-327,
// :409-410, :490-497). The caller keeps window <= P * ps. page_indices may be
// a column slice of a wider table: its row stride is an argument.

#pragma once

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

// Fused pages (paged_fused.py:86-103): one (hkv, num_pages, page_rows, D)
// array; a page holds K in rows [0, ps) and V in rows [ps, 2ps); an int8
// page adds sr scale rows for K and then sr for V, byte j of token i's f32
// scale at row 2ps + 4 * (i / D) + j (V: + sr), lane i % D.
template <typename P, int D>
struct FusedPages {
  const P* pages;
  int num_pages, page_size, page_rows;
  __device__ const P* page(int h, int id) const {
    return pages + ((size_t)h * num_pages + id) * page_rows * D;
  }
  __device__ const P* k_row(int h, int id, int r) const {
    return page(h, id) + (size_t)r * D;
  }
  __device__ const P* v_row(int h, int id, int r) const {
    return page(h, id) + (size_t)(page_size + r) * D;
  }
  __device__ float k_scale(int h, int id, int r) const {
    return page_scale<D>(reinterpret_cast<const int8_t*>(page(h, id)),
                         2 * page_size, r);
  }
  __device__ float v_scale(int h, int id, int r) const {
    const int sr = (page_rows - 2 * page_size) / 2;
    return page_scale<D>(reinterpret_cast<const int8_t*>(page(h, id)),
                         2 * page_size + sr, r);
  }
};

// Separate pages (paged.py:224-342): K and V arrays (hkv, num_pages, ps, D);
// an int8 cache adds f32 scales (hkv, num_pages, ps, 1) per side.
template <typename P, int D>
struct SeparatePages {
  const P* k;
  const P* v;
  const float* k_scales;
  const float* v_scales;
  int num_pages, page_size;
  __device__ size_t token(int h, int id, int r) const {
    return ((size_t)h * num_pages + id) * page_size + r;
  }
  __device__ const P* k_row(int h, int id, int r) const {
    return k + token(h, id, r) * D;
  }
  __device__ const P* v_row(int h, int id, int r) const {
    return v + token(h, id, r) * D;
  }
  __device__ float k_scale(int h, int id, int r) const {
    return k_scales[token(h, id, r)];
  }
  __device__ float v_scale(int h, int id, int r) const {
    return v_scales[token(h, id, r)];
  }
};

// T: q and out dtype; P: page element type (T, or int8_t for int8 pages);
// L: the page layout; RING: the sliding-window ring walk (window > 0).
template <typename T, typename P, int D, int G, bool RING, typename L>
__global__ void __launch_bounds__(WARPS * 32)
    paged_decode_kernel(const T* __restrict__ q, const L pages,
                        const int* __restrict__ lengths,
                        const int* __restrict__ page_indices, int pi_stride,
                        int pages_per_seq, T* __restrict__ out,
                        float* __restrict__ lse, int hkv, int window,
                        float scale_log2) {
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
  const int ps = pages.page_size;
  const float qscale = round_to<T>(scale_log2);
  for (int i = tid; i < G * D; i += WARPS * 32)
    qs[i / D][i % D] =
        round_to<T>(to_f(q[((size_t)b * hq + h * G) * D + i]) * qscale);
  __syncthreads();

  // tokens [first, n)
  const int n = RING ? max(0, lengths[b])
                     : max(0, min(lengths[b], pages_per_seq * ps));
  const int first = RING ? max(0, n - window) : 0;
  const int* pt = page_indices + (size_t)b * pi_stride;
  auto page_of = [&](int t) {
    const int lp = t / ps;
    return pt[RING ? lp % pages_per_seq : lp];
  };

  float m_run[G], l_run[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;  // per-lane partial, warp-reduced at the end
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int base = first + warp * CHUNK; base < n; base += WARPS * CHUNK) {
    // scores: lane `lane` takes token base + lane
    const int t = base + lane;
    float s[G];
    float vscale = 1.f;
    if (t < n) {
      const int id = page_of(t), r = t % ps;
      const P* krow = pages.k_row(h, id, r);
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
        const float kscale = pages.k_scale(h, id, r);
        vscale = pages.v_scale(h, id, r);
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
      const P* vrow = pages.v_row(h, page_of(tok), tok % ps) + lane * E;
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

// Launches the kernel for a group of 1, 2, 4 or 8 q heads per kv head.
template <typename T, typename P, int D, bool RING, typename L>
cudaError_t launch_group(int group, const void* q, const L& pages,
                         const void* lengths, const void* page_indices,
                         int pi_stride, int pages_per_seq, void* out,
                         void* lse, int batch, int hkv, int window,
                         float scale_log2, cudaStream_t stream) {
  const dim3 grid(hkv, batch);
#define TFA_DECODE_LAUNCH(G)                                               \
  paged_decode_kernel<T, P, D, G, RING, L><<<grid, WARPS * 32, 0, stream>>>( \
      static_cast<const T*>(q), pages, static_cast<const int*>(lengths),   \
      static_cast<const int*>(page_indices), pi_stride, pages_per_seq,     \
      static_cast<T*>(out), static_cast<float*>(lse), hkv, window,         \
      scale_log2)
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
