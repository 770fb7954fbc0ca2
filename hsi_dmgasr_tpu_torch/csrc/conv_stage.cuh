// Staging helpers shared by the port's implicit-GEMM convolutions
// (fused_conv.cu, up2_conv.cu): 256-thread CTAs that stage K chunks of 32
// channels as K-major 64-byte rows in shared memory, swizzled as
// wgmma.cuh's sw64_desc reads them, through cp.async; bf16 packing and the
// hi + lo split that carries an f32 operand on bf16 tensor cores.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;              // channels per K chunk
constexpr int ROWB = KC * 2;        // bytes of one (swizzled) row of K: 64
constexpr int SWZ = 512;            // the 64-byte swizzle's pattern: 8 rows
constexpr int NTHREADS = 256;       // 8 warps

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// (a, b) as bf16 pairs hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a - h.x, b - h.y);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// byte offset of 16-byte chunk c (8 channels) of row n in a tile of
// 64-byte rows with the 64-byte swizzle (sw64_desc's layout): the weight
// slices, the staged windows and the projection's operand. ldmatrix
// reads any 8 consecutive rows of one chunk without bank conflicts.
__device__ __forceinline__ uint32_t row_off(int n, int c) {
  return n * ROWB + ((c ^ ((n >> 1) & 3)) << 4);
}

// element offset of channel q of row n in such a tile (bf16 elements)
__device__ __forceinline__ int row_elem(int n, int q) {
  return (row_off(n, q >> 3) >> 1) + (q & 7);
}

// Start the copy of ROWS packed weight rows (KC bf16 each) into a slice at
// dst (512-byte aligned); rows at or past nvalid are zero-filled.
template <int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, int nvalid) {
  for (int u = threadIdx.x; u < ROWS * (KC / 8); u += NTHREADS) {
    const int n = u >> 2, c = u & 3;
    const bool valid = n < nvalid;
    cp_async16(dst + row_off(n, c), valid ? src + n * KC + c * 8 : src, valid);
  }
}

}  // namespace
