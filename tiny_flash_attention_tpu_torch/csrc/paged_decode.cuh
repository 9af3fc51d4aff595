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
// magnitude below the card's operations-per-byte ridge. By Little's law the
// card needs about 2 MB of loads in flight (3.35 TB/s times ~0.7 us), which
// one block per (kv head, sequence), 16 blocks for 8 sequences of 2 kv
// heads, cannot keep.
//
// The design: split-KV in one launch. The grid is (splits, kv heads,
// sequences); split x owns a contiguous, page-aligned range of the
// attended tokens, `pages_per_split` logical pages of the table (or of the
// ring's window), so a sequence's tokens are walked by `splits` blocks at
// once. A split's size is fixed in tokens and the count covers the
// table's width (host-known, never from the lengths: ops/configs.py::
// paged_decode_split_pages), so a result does not depend on how wide the
// table is; a split past a sequence's length has no token and gives an
// empty partial, which adds exact zeros to the merge.
//   - Loads: each of a block's WARPS warps walks 32-token chunks of the
//     split (chunk w, w + WARPS, ...) through its own ring of STAGES
//     stages in shared memory. One lane issues a chunk's K rows and V rows
//     as bulk copies (cp.async.bulk, completing on the stage's mbarrier):
//     the 32 rows of one page are one contiguous run per side (two runs of
//     16 at page_size 16), and an int8 page adds its scale rows, 32 bytes
//     of each of the 4 byte-rows per side (fused pages) or 128 bytes of f32
//     (separate), read once per chunk and not as single bytes per token.
//   - Scores: 8 lanes score one token, 4 tokens a step, each lane D/8
//     elements of the row in pieces of up to 16 bytes (piece p of lane i at
//     byte (i + 8 p) * piece, so a quarter-warp reads whole runs of the row
//     and no read conflicts), reduced by 3 shuffles; a lane keeps its slice
//     of the group's q in registers (in shared memory, in the lanes' order,
//     where that would take more than 64 registers). The piece is the
//     largest of 16, 8, 4 and 2 bytes that divides a lane's D/8 elements:
//     16 at head_dim 64 and 128 (8 for int8 at 64); at 80 and 96, whose
//     rows split into eight equal slices of 20 / 24 bytes (bf16) or 10 / 12
//     (int8), 4- and 8-byte pieces (2 and 4 for int8), so no lane idles and
//     the FMAs a lane does stay D/8 x G a token. int8 payloads convert
//     exactly by byte permute into an f32 2^23 + b + 128 and a subtract (no
//     int-to-float conversion pipe).
//   - Softmax per chunk (the warp's online softmax); p goes to shared
//     memory, and each lane accumulates its columns of P V over the
//     chunk's rows, reading p as a broadcast: D/32 contiguous columns at
//     head_dim 64 and 128 (whole 4-byte words, read at once), else the
//     ceil(D/32) columns lane, lane + 32, lane + 64 (at 80 the third only
//     in lanes 0-15), one element a read: 3 contiguous bf16 or int8 values
//     at 96 would straddle words.
//   - A warp's first chunks are in flight before q is staged.
//   - GQA groups: G q rows a kv head in one block, G in {1, 2, 4, 8}; the
//     caller pads a kv head's rows to the next G with zero rows (sliced
//     away), and above 8 covers them with `qblocks` row blocks of 8, each
//     its own grid row over the same pages (the second reads them from L2).
//   - The merge: the warps' (m, l, acc) combine in warp order into the
//     block's partial, which goes to a workspace (f32, cached per device
//     and shape by the caller); the block that arrives last at the
//     (sequence, kv head)'s counter merges the splits' partials in split
//     order, so the result does not depend on the arrival order, writes out
//     and the LSE, and resets the counter for the next call. Both merges
//     are the exact LSE combine (the math of parallel/ring.py:43-52). With
//     one split the block writes out directly.
// The arithmetic is the TPU kernels': softmax in the log2 domain with
// sm_scale * log2(e) folded into q in the input dtype, P rounded to the
// input dtype before the PV product, the mask value -0.7 * FLT_MAX, m
// starting at -inf and an empty or NaN l guarded (paged_fused.py:346,
// :443). int8 pages keep the TPU kernels' rounding points
// (paged_fused.py:389-436, paged.py:176-210): the payload converts
// exactly, the f32 score is multiplied by the token's K scale, l sums the
// unscaled p, and p times the token's V scale (in f32) is what rounds to
// q's dtype before the PV product.
//
// Without a window the attended tokens are [0, min(lengths[b], P * ps)): the
// kernel never reads a page id past the table width. With a window (RING)
// they are [max(0, length - window), length), not clamped, and token t lies
// on logical page (t / ps) % P: the table is a ring of P pages that holds the
// last window of tokens for an unbounded generation, and the walk costs
// O(window), not O(length) (the ring mode of paged_fused.py:316-327,
// :409-410, :490-497); the splits then cover the pages of the window,
// counted from the page of its first token. The caller keeps window <= P *
// ps. page_indices may be a column slice of a wider table: its row stride
// is an argument. The compiled widths: page_size 16 or a multiple of 32;
// head_dim 64, 80, 96 or 128 (every row a multiple of 16 bytes, so bulk copies move it), and
// 256: a warp's 32-token stage of bf16 pages is then 32 KiB (the block's
// rings 128 KiB, one block an SM), each lane scores 32 elements of a row in
// four 16-byte pieces and owns 8 contiguous output columns; the group's q
// stays in shared memory above G = 2 (G * 32 floats). f32 pages need 64
// KiB a warp there, 256 KiB for four, so their blocks take
// TFA_DECODE_F32_WIDE_WARPS warps (`decode_warps`): fewer chunks in flight
// a block, each split walked by fewer warps. At 256 G stops at 4 (a G = 8
// instance spilled 28 KB a thread): ops/dims.py::decode_group covers a
// group of 8 by two row blocks of 4, which read the same pages, the second
// from L2.
//
// Head dims in (256, 512] (paged_decode_wide.cu, paged_decode_separate_
// wide.cu: bf16 q over bf16 and int8 pages; paged_decode_f32_wide.cu,
// paged_decode_separate_f32_wide.cu: f32 q over f32 and int8 pages) run on
// instances of width 512: compiled at 512 (page size 16 or a multiple of
// 32) and at run time for every other d and page size, as below. A warp's
// 32-token bf16 stage is then 64 KiB and its two int8 stages 66,048 bytes,
// so a block takes TFA_DECODE_512_WARPS warps (`decode_warps`); each lane
// scores 64 elements of a row in eight (int8: four; f32: sixteen) 16-byte
// pieces and owns 16 contiguous output columns, so a q row costs it 16 PV
// accumulators and 8 scores, and the group's q stays in shared memory
// above G = 1. A 32-token stage of f32 pages would be 128 KiB a warp
// there, so f32 pages are walked in chunks of 16 tokens (`decode_chunk`):
// a 64 KiB stage, 3 warps a block as for bf16 pages, each chunk scored in
// four steps of 4 tokens. The groups the wrapper covers with row blocks
// stop lower there (ops/dims.py::DECODE_TOP_512, from the ptxas spill
// report).
//
// Every other head_dim in [1, 256] and page size (the JAX package takes
// any page size; pages are the cache and are never padded) runs on the
// run-time width instances (paged_decode_widths*.cu,
// paged_decode_separate_widths.cu): the layout's D is 0 and its rows are
// d wide, the instance's width D is 64, 128 or 256 (the least that holds
// d, `decode_width`) and the stages, q, the scoring slices and the PV
// columns are laid out at that width. What differs from the compiled
// widths is the load: a page edge may fall anywhere in a chunk (page size
// 48: tokens 32-63 lie on two pages; page size 1: 32 pages a chunk), and a
// row of d elements need not be whole 16-byte pieces (d 100: 200 bytes in
// bf16, 100 in int8), so bulk copies do not apply. Each lane copies pieces
// of the chunk's rows, token by token, by cp.async of 16, 8 or 4 bytes (the
// largest that divides a row: every row of the pages starts at a multiple
// of it), by a load and a store for rows of an odd number of 2-byte
// halves or bytes, each chunk one cp.async group; the stages are zeroed
// once, so the columns past d score and accumulate exact zeros (q's
// padded columns are zero too), and the epilogue stores d columns. int8
// scale bytes are read from the page by the token's lane, a chunk ahead.

#pragma once

#include <type_traits>

#include "hopper.cuh"

#if !defined(TFA_DECODE_WARPS) || !defined(TFA_DECODE_F32_WIDE_WARPS) || \
    !defined(TFA_DECODE_512_WARPS)
#error "the warp counts are passed by the build (ops/configs.py)"
#endif

namespace {

// Warps a block: TFA_DECODE_WARPS, or TFA_DECODE_F32_WIDE_WARPS over f32
// pages at head_dim 256, whose 32-token stage is 64 KiB a warp (four would
// need 256 KiB of rings), or TFA_DECODE_512_WARPS at width 512 (a bf16
// stage of 64 KiB, two int8 stages of 66,048 bytes, a 16-token f32 stage
// of 64 KiB)
template <typename P, int D>
__host__ __device__ constexpr int decode_warps() {
  return D > 256                       ? TFA_DECODE_512_WARPS
         : sizeof(P) == 4 && D > 128 ? TFA_DECODE_F32_WIDE_WARPS
                                       : TFA_DECODE_WARPS;
}
// Tokens a warp step: 32, or 16 over f32 pages above 256, whose 32-token
// stage of K and V would be 128 KiB a warp (int8 pages keep 32: their
// scale rows are laid out in 32-token groups)
template <typename P, int D>
__host__ __device__ constexpr int decode_chunk() {
  return sizeof(P) == 4 && D > 256 ? 16 : 32;
}

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

// rounds to the input dtype and back (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// The N page elements of a piece (16 bytes or fewer), exactly as f32: int8
// by byte permute into 2^23 + b + 128 and a subtract.
template <typename P, int N>
__device__ __forceinline__ void piece_to_f(const uint32_t* w, float* f) {
  if constexpr (sizeof(P) == 1) {
#pragma unroll
    for (int i = 0; i < (N + 3) / 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int b = 0; b < 4 && 4 * i + b < N; ++b)
        f[4 * i + b] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) -
            8388736.f;
    }
  } else if constexpr (sizeof(P) == 2) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = __uint_as_float(w[i]);
  }
}

// The 32-bit words of a PB-byte piece of shared memory (PB 16, 8, 4 or 2;
// a 2-byte piece in the low half of w[0]).
template <int PB>
__device__ __forceinline__ void load_piece(const unsigned char* p,
                                           uint32_t* w) {
  if constexpr (PB == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
  } else if constexpr (PB == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    w[0] = raw.x, w[1] = raw.y;
  } else if constexpr (PB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// QV consecutive floats of shared memory (QV 4 or 2)
template <int QV>
__device__ __forceinline__ void load_q(const float* p, float* v) {
  if constexpr (QV == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

// One page element as f32 (exact for int8)
template <typename P>
__device__ __forceinline__ float elem_to_f(P x) {
  if constexpr (sizeof(P) == 1)
    return (float)(int)x;
  else
    return to_f(x);
}

// Fused pages (paged_fused.py:86-103): one (hkv, num_pages, page_rows, d)
// array; a page holds K in rows [0, ps) and V in rows [ps, 2ps); an int8
// page adds sr scale rows for K and then sr for V, byte j of token i's f32
// scale at row 2ps + 4 * (i / d) + j (V: + sr), lane i % d. D is the row
// width d the instance compiles, or 0 for the run-time width instances,
// whose rows are `dim` elements.
template <typename P, int D>
struct FusedPages {
  static constexpr bool kRunTimeWidth = D == 0;
  const P* pages;
  int num_pages, page_size, page_rows;
  int dim;  // the row width where D is 0
  __device__ int width() const { return D > 0 ? D : dim; }
  __device__ const P* page(int h, int id) const {
    return pages + ((size_t)h * num_pages + id) * page_rows * width();
  }
  __device__ const P* k_row(int h, int id, int r) const {
    return page(h, id) + (size_t)r * width();
  }
  __device__ const P* v_row(int h, int id, int r) const {
    return page(h, id) + (size_t)(page_size + r) * width();
  }
  // the scale bytes of rows [r, r + n) into sc (K: [4][32] bytes, V: the
  // next 128), at token offset o of the chunk; a run that crosses a group
  // of D tokens (head_dim 80 at page_size 160: tokens 64-95) is two copies,
  // each a multiple of 16 bytes (16 divides D and the chunk's offsets)
  __device__ void load_scales(int h, int id, int r, int n, int o,
                              uint8_t* sc, uint64_t* bar) const {
    static_assert(D > 0, "the compiled widths' bulk copies");
    const int sr = (page_rows - 2 * page_size) / 2;
    const uint8_t* base = reinterpret_cast<const uint8_t*>(page(h, id));
    for (int a = 0; a < n;) {
      const int t = r + a, take = min(n - a, D - t % D);
      const size_t row = 2 * page_size + 4 * (t / D);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bulk_load(sc + 32 * j + o + a, base + (row + j) * D + t % D, take,
                  bar);
        bulk_load(sc + 128 + 32 * j + o + a,
                  base + (row + sr + j) * D + t % D, take, bar);
      }
      a += take;
    }
  }
  // token t's scale from the landed bytes (sc: K's, or sc + 128: V's)
  __device__ static float scale(const uint8_t* sc, int t) {
    return __uint_as_float((uint32_t)sc[t] | (uint32_t)sc[32 + t] << 8 |
                           (uint32_t)sc[64 + t] << 16 |
                           (uint32_t)sc[96 + t] << 24);
  }
  // row r's K and V scales read from the page, byte by byte (the run-time
  // width instances: a scale row of d bytes is no whole 16-byte piece)
  __device__ float2 token_scales(int h, int id, int r) const {
    const int d = width(), sr = (page_rows - 2 * page_size) / 2;
    const uint8_t* k = reinterpret_cast<const uint8_t*>(page(h, id)) +
                       (size_t)(2 * page_size + 4 * (r / d)) * d + r % d;
    const uint8_t* v = k + (size_t)sr * d;
    uint32_t kb = 0, vb = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kb |= (uint32_t)__ldg(k + (size_t)j * d) << 8 * j;
      vb |= (uint32_t)__ldg(v + (size_t)j * d) << 8 * j;
    }
    return make_float2(__uint_as_float(kb), __uint_as_float(vb));
  }
};

// Separate pages (paged.py:224-342): K and V arrays (hkv, num_pages, ps, d);
// an int8 cache adds f32 scales (hkv, num_pages, ps, 1) per side. D as in
// FusedPages.
template <typename P, int D>
struct SeparatePages {
  static constexpr bool kRunTimeWidth = D == 0;
  const P* k;
  const P* v;
  const float* k_scales;
  const float* v_scales;
  int num_pages, page_size;
  int dim;  // the row width where D is 0
  __device__ int width() const { return D > 0 ? D : dim; }
  __device__ size_t token(int h, int id, int r) const {
    return ((size_t)h * num_pages + id) * page_size + r;
  }
  __device__ const P* k_row(int h, int id, int r) const {
    return k + token(h, id, r) * width();
  }
  __device__ const P* v_row(int h, int id, int r) const {
    return v + token(h, id, r) * width();
  }
  __device__ void load_scales(int h, int id, int r, int n, int o,
                              uint8_t* sc, uint64_t* bar) const {
    bulk_load(sc + 4 * o, k_scales + token(h, id, r), 4 * n, bar);
    bulk_load(sc + 128 + 4 * o, v_scales + token(h, id, r), 4 * n, bar);
  }
  __device__ static float scale(const uint8_t* sc, int t) {
    return reinterpret_cast<const float*>(sc)[t];
  }
  __device__ float2 token_scales(int h, int id, int r) const {
    const size_t t = token(h, id, r);
    return make_float2(__ldg(k_scales + t), __ldg(v_scales + t));
  }
};

// 8-byte async copy (.ca: .cg takes 16 bytes only)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// One GB-byte piece of a row from device to shared memory: by cp.async for
// 16, 8 and 4 bytes, else by a load and a store.
template <int GB>
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src) {
  if constexpr (GB == 16)
    cp_async16(dst, src, true);
  else if constexpr (GB == 8)
    cp_async8(dst, src);
  else if constexpr (GB == 4)
    cp_async4(dst, src, true);
  else if constexpr (GB == 2)
    *reinterpret_cast<uint16_t*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  else
    *dst = __ldg(src);
}

// Ring stages a warp keeps, by page element size: two for int8, one for
// wider pages (the 2-byte stage is twice the size; other warps and blocks
// keep the loads in flight).
template <typename P>
__host__ __device__ constexpr int decode_stages() {
  return sizeof(P) == 1 ? 2 : 1;
}

template <typename P, int D>
__host__ __device__ constexpr int decode_stage_bytes() {
  return 2 * decode_chunk<P, D>() * D * (int)sizeof(P) +
         (sizeof(P) == 1 ? 256 : 0);
}

// Dynamic shared memory of one block: the warps' rings, q in the lanes'
// order, each warp's p of a chunk, the mbarriers (the warps' merge reuses
// the rings).
template <typename P, int D, int G>
__host__ __device__ constexpr int decode_smem_bytes() {
  constexpr int WARPS = decode_warps<P, D>();
  return WARPS * decode_stages<P>() * decode_stage_bytes<P, D>() +
         G * D * 4 + WARPS * decode_chunk<P, D>() * G * 4 +
         WARPS * decode_stages<P>() * 8;
}

// T: q and out dtype; P: page element type (T, or int8_t for int8 pages);
// D: the instance's width; L: the page layout, whose rows are D wide or, in
// the run-time width instances (L::kRunTimeWidth), any d <= D; RING: the
// sliding-window ring walk (window > 0).
template <typename T, typename P, int D, int G, bool RING, typename L>
__global__ void __launch_bounds__(decode_warps<P, D>() * 32)
    paged_decode_kernel(const T* __restrict__ q, const L pages,
                        const int* __restrict__ lengths,
                        const int* __restrict__ page_indices, int pi_stride,
                        int pages_per_seq, int pages_per_split,
                        T* __restrict__ out, float* __restrict__ lse,
                        float* ws, int* arrivals, int hkv, int qblocks,
                        int window, float scale_log2) {
  constexpr bool QUANT = sizeof(P) == 1;
  constexpr bool ANY = L::kRunTimeWidth;
  constexpr int WARPS = decode_warps<P, D>();
  constexpr int STAGES = decode_stages<P>();
  constexpr int SB = decode_stage_bytes<P, D>();
  constexpr int CHUNK = decode_chunk<P, D>();  // tokens a chunk
  constexpr int STEPS = CHUNK / 4;             // scoring steps a chunk
  static_assert(CHUNK == 32 || !QUANT, "int8 scale rows of 32 tokens");
  constexpr bool STRIDED = D % 64 != 0;      // PV columns lane + 32 e
  constexpr int E = (D + 31) / 32;           // PV: output elements a lane
  constexpr int LE = D / 8;                  // elements a lane scores
  constexpr int LB = LE * (int)sizeof(P);    // scores: row bytes a lane
  constexpr int PB = LB % 16 == 0 ? 16       // bytes a piece
                     : LB % 8 == 0 ? 8
                     : LB % 4 == 0 ? 4 : 2;
  constexpr int NP = LB / PB;                // pieces a lane
  constexpr int EP = PB / (int)sizeof(P);    // elements a piece
  constexpr int QV = EP % 4 == 0 ? 4 : 2;    // q floats a shared read
  constexpr bool QREG = G * LE <= 64;        // q in registers
  static_assert(D % 16 == 0 && LB % PB == 0 && NP * EP == LE && EP % QV == 0,
                "head_dim");
  static_assert(WARPS * G * (D + 2) * 4 <= WARPS * STAGES * SB,
                "the warps' merge fits in the rings");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* qp = reinterpret_cast<float*>(smem + WARPS * STAGES * SB);
  float* pw = qp + G * D + (threadIdx.x / 32) * CHUNK * G;  // [CHUNK][G]
  uint64_t* bars = reinterpret_cast<uint64_t*>(qp + G * D + WARPS * CHUNK * G);

  // grid row hv: q rows [hv * G, hv * G + G) of the (padded) q heads, over
  // kv head h's pages (qblocks grid rows a kv head); hkv counts grid rows
  const int split = blockIdx.x, hv = blockIdx.y, b = blockIdx.z;
  const int h = qblocks == 1 ? hv : hv / qblocks;
  const int splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hq = hkv * G;
  const int ps = pages.page_size;
  const int dd = ANY ? pages.width() : D;  // the rows' true width
  unsigned char* wring = ring + warp * STAGES * SB;
  uint64_t* wbar = bars + warp * STAGES;
  if constexpr (ANY) {
    // the stages' columns past dd stay zero (the copies write the first dd
    // of a row), so they score and accumulate exact zeros; the warp syncs
    // below before any copy is issued
    for (int x = lane; x < STAGES * SB / 16; x += 32)
      reinterpret_cast<uint4*>(wring)[x] = make_uint4(0, 0, 0, 0);
  }
  if (lane == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(&wbar[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // this split's tokens [t_lo, t_hi)
  const int P_ = pages_per_seq;
  const int n = RING ? max(0, lengths[b])
                     : max(0, min(lengths[b], P_ * ps));
  const int first = RING ? max(0, n - window) : 0;
  const int p0 = (RING ? first / ps : 0) + split * pages_per_split;
  const int t_lo = max(first, p0 * ps);
  const int t_hi = min(n, (p0 + pages_per_split) * ps);
  const int c_first = t_lo / CHUNK * CHUNK;
  const int n_chunks = t_hi > t_lo ? (t_hi - c_first + CHUNK - 1) / CHUNK : 0;
  const int mine =
      n_chunks > warp ? (n_chunks - warp + WARPS - 1) / WARPS : 0;
  const int* pt = page_indices + (size_t)b * pi_stride;
  auto page_of = [&](int t) {
    const int lp = t / ps;
    return pt[RING ? lp % P_ : lp];
  };
  const int seg = min(ps, CHUNK);  // rows of one page in a chunk

  // lane 0: the warp's local chunk c into its stage (the compiled widths,
  // page size 16 or a multiple of 32: a chunk's rows of one page are one
  // run of whole 16-byte pieces)
  auto issue = [&](int c) {
    if constexpr (!ANY) {
      const int c0 = c_first + (warp + WARPS * c) * CHUNK;
      unsigned char* st = wring + c % STAGES * SB;
      uint64_t* bar = &wbar[c % STAGES];
      uint32_t bytes = 0;
      for (int o = 0; o < CHUNK; o += seg)
        if (c0 + o + seg > t_lo && c0 + o < t_hi)
          bytes += seg * (2 * D * (int)sizeof(P) + (QUANT ? 8 : 0));
      mbar_expect_tx(bar, bytes);
      for (int o = 0; o < CHUNK; o += seg) {
        const int t = c0 + o;
        if (!(t + seg > t_lo && t < t_hi)) continue;
        const int id = page_of(t), r = t % ps;
        const uint32_t nb = seg * D * sizeof(P);
        bulk_load(st + o * D * sizeof(P), pages.k_row(h, id, r), nb, bar);
        bulk_load(st + (CHUNK + o) * D * sizeof(P), pages.v_row(h, id, r),
                  nb, bar);
        if constexpr (QUANT)
          pages.load_scales(h, id, r, seg, o,
                            st + 2 * CHUNK * D * sizeof(P), bar);
      }
    }
  };

  // The run-time width instances copy each token's K and V rows on their
  // own (a page edge may fall anywhere in a chunk, and a row of dd elements
  // need not be whole 16-byte pieces): row tt of the chunk into stage row
  // tt (V: CHUNK + tt), dd * sizeof(P) bytes as GR pieces of GB bytes, the
  // largest of 16, 8, 4, 2 and 1 that divides a row (every row of the pages
  // and of the stage starts at a multiple of it); the warp copies RPI rows
  // at once, lane (sub, gr0) piece gr0 (and gr0 + 32, ...) of row sub.
  const int row_bytes = dd * (int)sizeof(P);
  const int GB = row_bytes % 16 == 0 ? 16
                 : row_bytes % 8 == 0 ? 8
                 : row_bytes % 4 == 0 ? 4
                 : row_bytes % 2 == 0 ? 2 : 1;
  const int GR = row_bytes / GB;
  const int RPI = GR >= 32 ? 1 : 32 / GR;
  const int sub = GR >= 32 ? 0 : lane / GR;  // >= RPI: the lane idles
  const int gr0 = GR >= 32 ? lane : lane % GR;
  auto copy_rows = [&](auto gb, int c) {
    constexpr int B = decltype(gb)::value;
    const int c0 = c_first + (warp + WARPS * c) * CHUNK;
    unsigned char* st = wring + c % STAGES * SB;
    for (int tt = sub; tt < CHUNK && sub < RPI; tt += RPI) {
      const int t = c0 + tt;
      if (t < t_lo || t >= t_hi) continue;
      const int id = page_of(t), r = t % ps;
      const auto* k = reinterpret_cast<const unsigned char*>(
          pages.k_row(h, id, r));
      const auto* v = reinterpret_cast<const unsigned char*>(
          pages.v_row(h, id, r));
      unsigned char* kd = st + tt * D * sizeof(P);
      unsigned char* vd = st + (CHUNK + tt) * D * sizeof(P);
      for (int g = gr0; g < GR; g += 32) {
        copy_piece<B>(kd + g * B, k + g * B);
        copy_piece<B>(vd + g * B, v + g * B);
      }
    }
  };
  // every lane: the warp's local chunk c (none past `mine`) as one
  // cp.async group, committed in any case so that group c is the c-th
  auto issue_rows = [&](int c) {
    if constexpr (ANY) {
      if (c < mine) {
        switch (GB) {
          case 16: copy_rows(std::integral_constant<int, 16>(), c); break;
          case 8: copy_rows(std::integral_constant<int, 8>(), c); break;
          case 4: copy_rows(std::integral_constant<int, 4>(), c); break;
          case 2: copy_rows(std::integral_constant<int, 2>(), c); break;
          default: copy_rows(std::integral_constant<int, 1>(), c);
        }
      }
      cp_async_commit();
    }
  };
  // int8 pages at a run-time width: the K and V scales of the lane's token
  // of local chunk c, read from the page (1 past the attended tokens)
  auto chunk_scales = [&](int c) {
    const int t = c_first + (warp + WARPS * c) * CHUNK + lane;
    float2 sc = make_float2(1.f, 1.f);
    if constexpr (ANY && QUANT)
      if (c < mine && t >= t_lo && t < t_hi)
        sc = pages.token_scales(h, page_of(t), t % ps);
    return sc;
  };
  if constexpr (ANY) {
    for (int c = 0; c < STAGES; ++c) issue_rows(c);
  } else if (lane == 0) {
    for (int c = 0; c < min(STAGES, mine); ++c) issue(c);
  }
  float2 next_sc = make_float2(1.f, 1.f);
  if constexpr (ANY && QUANT) next_sc = chunk_scales(0);

  // q folded by scale_log2 in its dtype, in the lanes' order: element l of
  // lane i's scoring slice (piece l / EP at piece index i + 8 * piece) at
  // qp[((g * LE / QV + l / QV) * 8 + i) * QV + l % QV]
  const float qscale = round_to<T>(scale_log2);
  for (int x = tid; x < G * D; x += WARPS * 32) {
    const int g = x / D, d = x % D;
    const int pc = d / EP, i = pc % 8, l = pc / 8 * EP + d % EP;
    qp[((g * (LE / QV) + l / QV) * 8 + i) * QV + l % QV] =
        d < dd ? round_to<T>(
                     to_f(q[((size_t)b * hq + hv * G + g) * dd + d]) * qscale)
               : 0.f;
  }
  __syncthreads();
  float qr[QREG ? G : 1][QREG ? LE : QV];
  if constexpr (QREG) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int lv = 0; lv < LE / QV; ++lv)
        load_q<QV>(qp + ((g * (LE / QV) + lv) * 8 + lane % 8) * QV,
                   &qr[g][QV * lv]);
  }

  float m_run[G], l_run[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  const int j = lane / 8, i = lane % 8;  // scoring: token 4 st + j, slice i
  // PV: lane's output column e, live below D (at head_dim 64 and 128 every
  // column, known at compile time)
  auto col = [&](int e) { return STRIDED ? lane + 32 * e : lane * E + e; };
  auto live = [&](int e) { return !STRIDED || lane + 32 * e < D; };

  for (int c = 0; c < mine; ++c) {
    const int c0 = c_first + (warp + WARPS * c) * CHUNK;
    if constexpr (ANY) {
      cp_async_wait<STAGES - 1>();  // this lane's pieces of chunk c
      __syncwarp();                 // ... and every other lane's
    } else {
      mbar_wait(&wbar[c % STAGES], (c / STAGES) & 1);
    }
    const unsigned char* st = wring + c % STAGES * SB;
    const P* ks = reinterpret_cast<const P*>(st);
    const P* vs = ks + CHUNK * D;
    const uint8_t* sc = st + 2 * CHUNK * D * sizeof(P);
    // the chunk's scales, lane = token
    float kscale = 1.f, vscale = 1.f;
    if constexpr (QUANT && ANY) {
      kscale = next_sc.x;
      vscale = next_sc.y;
      next_sc = chunk_scales(c + 1);  // lands while this chunk is scored
    } else if constexpr (QUANT) {
      kscale = L::scale(sc, lane);
      vscale = L::scale(sc + 128, lane);
    }

    // scores, 4 tokens a step
    float s[STEPS][G];
#pragma unroll
    for (int stp = 0; stp < STEPS; ++stp) {
      const int tt = 4 * stp + j;
      const unsigned char* krow =
          reinterpret_cast<const unsigned char*>(ks + tt * D);
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll
      for (int pc = 0; pc < NP; ++pc) {
        uint32_t w[PB >= 4 ? PB / 4 : 1];
        load_piece<PB>(krow + (i + 8 * pc) * PB, w);
        float kf[EP];
        piece_to_f<P, EP>(w, kf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int ev = 0; ev < EP / QV; ++ev) {
            const int l = pc * EP + QV * ev;
            float qv[QV];
            if constexpr (QREG) {
#pragma unroll
              for (int u = 0; u < QV; ++u) qv[u] = qr[g][l + u];
            } else {
              load_q<QV>(qp + ((g * (LE / QV) + l / QV) * 8 + i) * QV, qv);
            }
#pragma unroll
            for (int u = 0; u < QV; ++u)
              part[g] = fmaf(qv[u], kf[QV * ev + u], part[g]);
          }
      }
      const float ksc = QUANT ? __shfl_sync(0xffffffffu, kscale, tt) : 1.f;
      const int t = c0 + tt;
      const bool ok = t >= t_lo && t < t_hi;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float x = part[g];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        s[stp][g] = ok ? (QUANT ? x * ksc : x) : kMaskValue;
      }
    }

    // the online softmax over the chunk; s becomes p, rounded to T (int8:
    // times the token's V scale)
    float vsc[STEPS];
#pragma unroll
    for (int stp = 0; stp < STEPS; ++stp)
      vsc[stp] = QUANT ? __shfl_sync(0xffffffffu, vscale, 4 * stp + j) : 1.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int stp = 1; stp < STEPS; ++stp) mx = fmaxf(mx, s[stp][g]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      mx = fmaxf(mx, m_run[g]);
      const float alpha = exp2f(m_run[g] - mx);
      const float keep = mx > 0.5f * kMaskValue ? 1.f : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int stp = 0; stp < STEPS; ++stp) {
        const float pf = exp2f(s[stp][g] - mx) * keep;
        psum += pf;
        s[stp][g] = round_to<T>(QUANT ? pf * vsc[stp] : pf);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 8);
      psum += __shfl_xor_sync(0xffffffffu, psum, 16);
      l_run[g] = alpha * l_run[g] + psum;
      m_run[g] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
    if (i == 0) {  // token 4 stp + j's p, for the whole warp
#pragma unroll
      for (int stp = 0; stp < STEPS; ++stp)
#pragma unroll
        for (int g = 0; g < G; ++g) pw[(4 * stp + j) * G + g] = s[stp][g];
    }
    __syncwarp();

    // P V: lane `lane` owns output columns col(e), e < E
#pragma unroll
    for (int tt = 0; tt < CHUNK; ++tt) {
      const int t = c0 + tt;
      if (t < t_lo || t >= t_hi) continue;  // the same for the whole warp
      uint32_t w[E * sizeof(P) >= 4 ? E * sizeof(P) / 4 : 1];
      const unsigned char* vrow = reinterpret_cast<const unsigned char*>(
          vs + tt * D + lane * E);
      float vf[E];
      if constexpr (STRIDED) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          vf[e] = live(e) ? elem_to_f(vs[tt * D + col(e)]) : 0.f;
      } else if constexpr (E * sizeof(P) == 2) {  // int8 at head_dim 64
        const uint32_t h16 = *reinterpret_cast<const uint16_t*>(vrow);
        w[0] = h16;
        float f4[4];
        piece_to_f<P, 4>(w, f4);
        vf[0] = f4[0], vf[1] = f4[1];
      } else {
#pragma unroll
        for (int x = 0; x < E * (int)sizeof(P) / 4; ++x)
          w[x] = reinterpret_cast<const uint32_t*>(vrow)[x];
        piece_to_f<P, E>(w, vf);
      }
      float pg[G];
      if constexpr (G % 4 == 0) {
#pragma unroll
        for (int g4 = 0; g4 < G / 4; ++g4) {
          const float4 v = reinterpret_cast<const float4*>(pw + tt * G)[g4];
          pg[4 * g4] = v.x, pg[4 * g4 + 1] = v.y;
          pg[4 * g4 + 2] = v.z, pg[4 * g4 + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) pg[g] = pw[tt * G + g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pg[g], vf[e], acc[g][e]);
    }
    __syncwarp();  // the stage and p are read: both may be refilled
    if constexpr (ANY)
      issue_rows(c + STAGES);
    else if (lane == 0 && c + STAGES < mine)
      issue(c + STAGES);
  }

  // the warps' (m, l, acc), merged in warp order into the block's partial
  if constexpr (ANY) cp_async_wait<0>();  // only empty groups are left
  __syncthreads();  // the rings are read and every copy has landed
  float* red_m = reinterpret_cast<float*>(smem);
  float* red_l = red_m + WARPS * G;
  float* red_acc = red_l + WARPS * G;  // [WARPS][G][D]
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      red_m[warp * G + g] = m_run[g];
      red_l[warp * G + g] = l_run[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (live(e)) red_acc[(warp * G + g) * D + col(e)] = acc[g][e];
  }
  __syncthreads();

  // a partial that saw no token keeps m = -inf and weighs nothing
  auto write_out = [&](int g, int d, float m_f, float num, float den) {
    const float l_safe = (den == 0.f || den != den) ? 1.f : den;
    const size_t row = (size_t)b * hq + hv * G + g;
    out[row * dd + d] = from_f<T>(num / l_safe);
    if (d == 0)
      lse[row] = (m_f == -INFINITY ? kMaskValue : m_f) * kLn2 + logf(l_safe);
  };
  float* mine_ws =
      ws + (((size_t)b * hkv + hv) * splits + split) * G * (dd + 2);
  for (int x = tid; x < G * dd; x += WARPS * 32) {
    const int g = x / dd, d = x % dd;
    float m_b = -INFINITY;
    for (int w = 0; w < WARPS; ++w) m_b = fmaxf(m_b, red_m[w * G + g]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float mw = red_m[w * G + g];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - m_b);
      num += red_acc[(w * G + g) * D + d] * wt;
      den += red_l[w * G + g] * wt;
    }
    if (splits == 1) {
      write_out(g, d, m_b, num, den);
    } else {
      mine_ws[g * (dd + 2) + 2 + d] = num;
      if (d == 0) {
        mine_ws[g * (dd + 2)] = m_b;
        mine_ws[g * (dd + 2) + 1] = den;
      }
    }
  }
  if (splits == 1) return;

  // the last split to arrive merges them all, in split order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* count = arrivals + (size_t)b * hkv + hv;
  if (tid == 0) last = atomicAdd(count, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = ws + ((size_t)b * hkv + hv) * splits * G * (dd + 2);
  for (int x = tid; x < G * dd; x += WARPS * 32) {
    const int g = x / dd, d = x % dd;
    float m_f = -INFINITY;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)
      m_f = fmaxf(m_f, __ldcg(all + (sp * G + g) * (dd + 2)));
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const float* part = all + (sp * G + g) * (dd + 2);
      const float ms = __ldcg(part);
      const float wt = ms == -INFINITY ? 0.f : exp2f(ms - m_f);
      num += __ldcg(part + 2 + d) * wt;
      den += __ldcg(part + 1) * wt;
    }
    write_out(g, d, m_f, num, den);
  }
  if (tid == 0) *count = 0;  // ready for the next call
}

// Launches the kernel for a group of 1, 2, 4 or 8 q rows per grid row (at
// most 4 above head_dim 128, 2 above 256), qblocks grid rows per kv head (q holds hkv *
// qblocks * group rows a sequence), over `splits` splits of
// `pages_per_split` pages; ws holds batch * hkv * qblocks * splits * group
// * (D + 2) floats and arrivals batch * hkv * qblocks zeroed ints (both
// unused with one split).
template <typename T, typename P, int D, bool RING, typename L>
cudaError_t launch_group(int group, const void* q, const L& pages,
                         const void* lengths, const void* page_indices,
                         int pi_stride, int pages_per_seq, int splits,
                         int pages_per_split, void* out, void* lse, void* ws,
                         void* arrivals, int batch, int hkv, int qblocks,
                         int window, float scale_log2, cudaStream_t stream) {
  const dim3 grid(splits, hkv * qblocks, batch);
#define TFA_DECODE_LAUNCH(G)                                                 \
  {                                                                          \
    const auto kernel = paged_decode_kernel<T, P, D, G, RING, L>;           \
    constexpr int smem = decode_smem_bytes<P, D, G>();                       \
    static bool smem_set[kMaxDevices] = {};                                  \
    const cudaError_t err = raise_smem_limit(kernel, smem, smem_set);       \
    if (err != cudaSuccess) return err;                                      \
    constexpr int threads = decode_warps<P, D>() * 32;                       \
    kernel<<<grid, threads, smem, stream>>>(                                 \
        static_cast<const T*>(q), pages, static_cast<const int*>(lengths),  \
        static_cast<const int*>(page_indices), pi_stride, pages_per_seq,    \
        pages_per_split, static_cast<T*>(out), static_cast<float*>(lse),    \
        static_cast<float*>(ws), static_cast<int*>(arrivals),              \
        hkv * qblocks, qblocks, window, scale_log2);                         \
  }
  switch (group) {
    case 1: TFA_DECODE_LAUNCH(1); break;
    case 2: TFA_DECODE_LAUNCH(2); break;
    case 4:
      // at width 512 a G = 4 instance spilled 20-25 KB a thread (compiled)
      // and 1.7 KB (run-time int8) where G = 2 spills none
      if constexpr (D > 256) return cudaErrorInvalidValue;
      else TFA_DECODE_LAUNCH(4);
      break;
    case 8:
      if constexpr (D > 128) return cudaErrorInvalidValue;
      else TFA_DECODE_LAUNCH(8);
      break;
    default: return cudaErrorInvalidValue;
  }
#undef TFA_DECODE_LAUNCH
  return cudaGetLastError();
}

// The instance width that reads head_dim d: with `widths` (the run-time
// width instances of paged_decode_widths*.cu and
// paged_decode_separate_widths.cu) the least of 64, 128 and 256 that holds
// d, else d itself where an instance of d compiles (64, 80, 96, 128, 256);
// with `wide` (the sources above 256) 512, for d in (256, 512] with
// `widths` and d == 512 without; 0 where none does.
// ops/dims.py::decode_compiled picks the sources (and decode_width the
// width) alike.
inline int decode_width(int d, bool widths, bool wide = false) {
  if (wide) return (widths ? d > 256 && d <= 512 : d == 512) ? 512 : 0;
  if (widths)
    return d < 1 || d > 256 ? 0 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
  return d == 64 || d == 80 || d == 96 || d == 128 || d == 256 ? d : 0;
}

// Calls fn(std::integral_constant<int, W>()) for the width W of
// decode_width(head_dim, WIDTHS, WIDE); cudaErrorInvalidValue where there
// is none.
template <bool WIDTHS, bool WIDE, typename F>
cudaError_t with_width(int head_dim, F fn) {
  if constexpr (WIDE) {
    if (decode_width(head_dim, WIDTHS, true) == 512)
      return fn(std::integral_constant<int, 512>());
  } else {
    switch (decode_width(head_dim, WIDTHS)) {
      case 64: return fn(std::integral_constant<int, 64>());
      case 128: return fn(std::integral_constant<int, 128>());
      case 256: return fn(std::integral_constant<int, 256>());
      case 80:
        if constexpr (!WIDTHS) return fn(std::integral_constant<int, 80>());
        break;
      case 96:
        if constexpr (!WIDTHS) return fn(std::integral_constant<int, 96>());
        break;
    }
  }
  return cudaErrorInvalidValue;
}

// The argument rules of both entries; the compiled widths (WIDTHS false)
// take page size 16 or a multiple of 32 only, whose chunks' rows of one
// page are one bulk copy; the run-time width instances any page size.
template <bool WIDTHS>
bool decode_args_ok(int batch, int hq, int hkv, int qblocks, int page_size,
                    int pages_per_seq, int splits, int pages_per_split,
                    const void* ws, const void* arrivals) {
  return batch > 0 && hkv > 0 && qblocks > 0 && hq % (hkv * qblocks) == 0 &&
         page_size > 0 && (WIDTHS || page_size == 16 || page_size % 32 == 0) &&
         pages_per_seq > 0 && splits >= 1 && pages_per_split >= 1 &&
         (splits == 1 || (ws != nullptr && arrivals != nullptr));
}

// Launches over fused pages: T q's dtype, P the pages' (T, or int8_t), D
// the instance's width; with WIDTHS the rows are head_dim <= D wide.
template <typename T, typename P, int D, bool WIDTHS>
cudaError_t launch_fused(int group, const void* q, const void* pages,
                         const void* lengths, const void* page_indices,
                         int pi_stride, int pages_per_seq, int splits,
                         int pages_per_split, void* out, void* lse, void* ws,
                         void* arrivals, int batch, int hkv, int qblocks,
                         int num_pages, int page_size, int page_rows,
                         int head_dim, int window, float scale_log2,
                         cudaStream_t stream) {
  const FusedPages<P, WIDTHS ? 0 : D> layout{
      static_cast<const P*>(pages), num_pages, page_size, page_rows,
      head_dim};
  if (window > 0)
    return launch_group<T, P, D, true>(
        group, q, layout, lengths, page_indices, pi_stride, pages_per_seq,
        splits, pages_per_split, out, lse, ws, arrivals, batch, hkv, qblocks,
        window, scale_log2, stream);
  return launch_group<T, P, D, false>(
      group, q, layout, lengths, page_indices, pi_stride, pages_per_seq,
      splits, pages_per_split, out, lse, ws, arrivals, batch, hkv, qblocks,
      0, scale_log2, stream);
}

template <typename X>
struct PageType {
  using type = X;
};

// q's and the pages' element types, as a tag
template <typename Q, typename X>
struct DecodeTypes {
  using q = Q;
  using page = X;
};

// One fused-page launch for q of type T over pages of q's type
// (quantized 0) or int8 pages (quantized 1), the arguments checked as
// tfa_paged_decode documents them, on the compiled widths or (WIDTHS) the
// run-time width instances, up to 256 or (WIDE) at width 512; a
// cudaError_t.
template <typename T, bool WIDTHS, bool WIDE = false>
cudaError_t fused_decode(const void* q, const void* pages,
                         const void* lengths, const void* page_indices,
                         int pi_stride, int pages_per_seq, int splits,
                         int pages_per_split, void* out, void* lse, void* ws,
                         void* arrivals, int batch, int hq, int hkv,
                         int qblocks, int num_pages, int page_size,
                         int page_rows, int head_dim, int window,
                         float scale_log2, int quantized,
                         cudaStream_t stream) {
  if (!decode_args_ok<WIDTHS>(batch, hq, hkv, qblocks, page_size,
                              pages_per_seq, splits, pages_per_split, ws,
                              arrivals) ||
      window < 0 || window > pages_per_seq * page_size ||
      (quantized ? page_rows <= 2 * page_size : page_rows != 2 * page_size))
    return cudaErrorInvalidValue;
  const int group = hq / (hkv * qblocks);
  const auto widths = [&](auto page) {
    return with_width<WIDTHS, WIDE>(head_dim, [&](auto width) {
      return launch_fused<T, typename decltype(page)::type,
                          decltype(width)::value, WIDTHS>(
          group, q, pages, lengths, page_indices, pi_stride, pages_per_seq,
          splits, pages_per_split, out, lse, ws, arrivals, batch, hkv,
          qblocks, num_pages, page_size, page_rows, head_dim, window,
          scale_log2, stream);
    });
  };
  return quantized ? widths(PageType<int8_t>()) : widths(PageType<T>());
}

// One launch over separate K and V page arrays (q of type T: 0 bf16, 1
// f32; pages of q's type, or int8 with f32 scales), on the compiled widths
// or (WIDTHS) the run-time width instances, up to 256 or (WIDE) at width
// 512; q of either type, or of QDTYPE only where it is 0 or 1 (each
// width-512 source instantiates one); a cudaError_t.
template <bool WIDTHS, bool WIDE = false, int QDTYPE = -1>
cudaError_t separate_decode(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* lengths, const void* page_indices,
    int pi_stride, int pages_per_seq, int splits, int pages_per_split,
    void* out, void* lse, void* ws, void* arrivals, int batch, int hq,
    int hkv, int qblocks, int num_pages, int page_size, int head_dim,
    float scale_log2, int dtype, int quantized, cudaStream_t stream) {
  if (!decode_args_ok<WIDTHS>(batch, hq, hkv, qblocks, page_size,
                              pages_per_seq, splits, pages_per_split, ws,
                              arrivals) ||
      (quantized && (k_scales == nullptr || v_scales == nullptr)) ||
      dtype < 0 || dtype > 1 || (QDTYPE >= 0 && dtype != QDTYPE))
    return cudaErrorInvalidValue;
  const int group = hq / (hkv * qblocks);
  const auto launch = [&](auto types) {
    using T = typename decltype(types)::q;
    using P = typename decltype(types)::page;
    return with_width<WIDTHS, WIDE>(head_dim, [&](auto width) {
      constexpr int D = decltype(width)::value;
      const SeparatePages<P, WIDTHS ? 0 : D> layout{
          static_cast<const P*>(k), static_cast<const P*>(v),
          static_cast<const float*>(k_scales),
          static_cast<const float*>(v_scales), num_pages, page_size,
          head_dim};
      return launch_group<T, P, D, false>(
          group, q, layout, lengths, page_indices, pi_stride, pages_per_seq,
          splits, pages_per_split, out, lse, ws, arrivals, batch, hkv,
          qblocks, 0, scale_log2, stream);
    });
  };
  if constexpr (QDTYPE != 1) {
    if (dtype == 0)
      return quantized ? launch(DecodeTypes<__nv_bfloat16, int8_t>())
                       : launch(DecodeTypes<__nv_bfloat16, __nv_bfloat16>());
  }
  if constexpr (QDTYPE != 0)
    return quantized ? launch(DecodeTypes<float, int8_t>())
                     : launch(DecodeTypes<float, float>());
  else
    return cudaErrorInvalidValue;
}

}  // namespace
