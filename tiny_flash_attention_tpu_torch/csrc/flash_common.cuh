// Pieces shared by the flash-attention forward (flash_fwd.cu) and backward
// (flash_bwd.cu) kernels: cp.async copies, ldmatrix loads, the bf16
// mma.sync m16n8k16 product, the causal tile clamp and the one-time raise
// of a kernel's dynamic shared-memory limit.
//
// Fragment layouts of mma.sync.m16n8k16 (row.col, bf16 in, f32 out), which
// every kernel here relies on:
//   A (16 x 16): a[0] rows 0-7 / k 0-7, a[1] rows 8-15 / k 0-7,
//                a[2] rows 0-7 / k 8-15, a[3] rows 8-15 / k 8-15;
//   C (16 x 8):  c[0], c[1] at row lane / 4, columns (lane % 4) * 2 + {0, 1};
//                c[2], c[3] the same columns at row lane / 4 + 8.
// So two neighbouring C tiles of one product, packed to bf16, are the A
// fragment of the next product over those 16 columns (pack_bf16 below).
// An operand stored [n][k] (k contiguous) loads as B with ldsm_x4; one
// stored [k][n] loads with ldsm_x4_trans.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * FLT_MAX;
constexpr float kLn2 = 0.69314718055994530942f;
constexpr float kLog2e = 1.44269504088896340736f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

// 4-byte async copy (.ca: .cg takes 16 bytes only); src_bytes == 0
// zero-fills the destination.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Number of kv tiles a q tile visits: up to the causal clamp, and at least
// one, so rows that precede every kv position still get the masked sentinel.
__device__ __forceinline__ int kv_tiles(int q0, int rows, int q_len,
                                        int kv_len, int causal, int bn) {
  const int n_all = (kv_len + bn - 1) / bn;
  if (!causal) return n_all;
  const int last = min(q0 + rows, q_len) - 1 + (kv_len - q_len);
  return last < 0 ? 1 : min(n_all, last / bn + 1);
}

constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared memory limit once per device (the
// attribute lives in the device's context) rather than on every launch.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, int smem,
                             bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace
