// The f32 register tiles of the CUDA-core kernels (never TF32) that the
// flash forward (flash_fwd.cuh's f32 body) and backward (flash_bwd.cu's f32
// path) share: row-major tiles in shared memory, each row's 16-byte chunks
// XOR-swizzled by row % 8, so that cp.async copies land unchanged and the
// strided float4 reads of the products are free of bank conflicts; the
// score product (RW x CW outputs a thread: 8 x 4, or 4 x 2 on the head_dim
// 256 instances' smaller tiles, 4 x 1 on the forward's of width 512) and
// the accumulating product (RW x C / G outputs a thread, G the threads
// along a row: 16, or 32 at width 512), both fed by 16-byte shared-memory
// reads; and the work lists that cut each tile's range into runs.

#pragma once

#include "flash_common.cuh"

namespace {

// Float offset of element (r, c) in a row-major tile of W-wide rows, its
// 16-byte chunks swizzled by r % 8.
template <int W>
__device__ __forceinline__ int sw(int r, int c) {
  return r * W + ((((c >> 2) ^ r) & 7) | ((c >> 2) & ~7)) * 4 + (c & 3);
}

// rows [r0, r0 + ROWS) of a row-major (n_rows, D) matrix into a swizzled
// tile by cp.async, THREADS threads of which this is `tid`; rows past n_rows
// land as zeros
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile(float* t, const float* g, int r0,
                                           int n_rows, int tid) {
  constexpr int C4 = D / 4;
#pragma unroll
  for (int x = tid; x < ROWS * C4; x += THREADS) {
    const int r = x / C4, c = (x % C4) * 4;
    const bool ok = r0 + r < n_rows;
    cp_async16(t + sw<D>(r, c), g + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

// A tile row of consecutive 4-byte values from `g` at [r0, r0 + rows), 0
// past n: the value at r0 + lane, by one thread a value
__device__ __forceinline__ void stage_row(void* dst, const void* g, int r0,
                                          int n, int lane) {
  const bool ok = r0 + lane < n;
  cp_async4(static_cast<int*>(dst) + lane,
            static_cast<const int*>(g) + (ok ? r0 + lane : 0), ok);
}

// acc[k][i] = sum_d R[RW a + k][d] * C[g + G i][d] over the head dim (RW
// rows, CW columns a thread), each operand times its scale where SR / SC
// (the q fold, rounded per element as the plain version rounds q * c): R's
// rows are read as float4s that the warp's G threads of one `a` share, C's
// as float4s of G rows.
template <int D, int RW, int CW, bool SR, bool SC, int G = 16>
__device__ __forceinline__ void score_tile(float (&acc)[RW][CW],
                                           const float* R, const float* C,
                                           float scale, int a, int g) {
#pragma unroll
  for (int k = 0; k < RW; ++k)
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[k][i] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 cv[CW];
#pragma unroll
    for (int i = 0; i < CW; ++i) {
      cv[i] = *reinterpret_cast<const float4*>(C + sw<D>(g + G * i, c));
      if (SC) {
        cv[i].x *= scale; cv[i].y *= scale;
        cv[i].z *= scale; cv[i].w *= scale;
      }
    }
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      float4 rv = *reinterpret_cast<const float4*>(R + sw<D>(RW * a + k, c));
      if (SR) {
        rv.x *= scale; rv.y *= scale;
        rv.z *= scale; rv.w *= scale;
      }
#pragma unroll
      for (int i = 0; i < CW; ++i) {
        acc[k][i] = fmaf(rv.x, cv[i].x, acc[k][i]);
        acc[k][i] = fmaf(rv.y, cv[i].y, acc[k][i]);
        acc[k][i] = fmaf(rv.z, cv[i].z, acc[k][i]);
        acc[k][i] = fmaf(rv.w, cv[i].w, acc[k][i]);
      }
    }
  }
}

// acc[k][j] += sum_x A[x][RW * a + k] * B[x][4 (e + G (j / 4)) + j % 4]
// over the X rows x of both: A an X x AW score tile, B an X x C slice of a
// tile of W-wide rows (W = C, or a column part of a wider tile: B then
// points at its first column, a multiple of 32); this thread's RW rows of
// A's columns, its C / G columns of B in chunks e + G c
template <int C, int RW, int AW, int X = 64, int W = C, int G = 16>
__device__ __forceinline__ void accumulate(float (&acc)[RW][C / G],
                                           const float* A, const float* B,
                                           int a, int e) {
  constexpr int NC = C / (4 * G);                // B chunks a thread
#pragma unroll 4
  for (int x = 0; x < X; ++x) {
    float av[RW];
#pragma unroll
    for (int h = 0; h < RW / 4; ++h) {
      const float4 v4 =
          *reinterpret_cast<const float4*>(A + sw<AW>(x, RW * a + 4 * h));
      av[4 * h] = v4.x; av[4 * h + 1] = v4.y;
      av[4 * h + 2] = v4.z; av[4 * h + 3] = v4.w;
    }
#pragma unroll
    for (int cc = 0; cc < NC; ++cc) {
      const float4 b4 = *reinterpret_cast<const float4*>(
          B + sw<W>(x, 4 * (e + G * cc)));
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        acc[k][4 * cc] = fmaf(av[k], b4.x, acc[k][4 * cc]);
        acc[k][4 * cc + 1] = fmaf(av[k], b4.y, acc[k][4 * cc + 1]);
        acc[k][4 * cc + 2] = fmaf(av[k], b4.z, acc[k][4 * cc + 2]);
        acc[k][4 * cc + 3] = fmaf(av[k], b4.w, acc[k][4 * cc + 3]);
      }
    }
  }
}

// A work list (ops/flash.py::run_work), int32: tile[n], lo[n], hi[n] (the
// item's range of the other side's tiles), order[n] (the item of each
// block rank, longest range first), first[tiles + 1] (tile t's items are
// first[t] .. first[t + 1] - 1, in range order).
struct Work {
  const int *tile, *lo, *hi, *order, *first;
  __host__ __device__ Work(const int* w, int n)
      : tile(w), lo(w + n), hi(w + 2 * n), order(w + 3 * n),
        first(w + 4 * n) {}
};

}  // namespace
