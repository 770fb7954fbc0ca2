// Blocked dot for Hopper (sm_90a): out = x @ w with the whole K reduced in
// each output tile, int8 x int8 -> int32 or bf16 x bf16 -> f32.
//
// Replaces the TPU kernel tools/microbench_int8.py:pallas_dot / kern (the
// pl.pallas_call at :88), the int8 feasibility probe's minimal Pallas dot.
// It computes what kern computes: each output element is the full-K dot of
// a row of x and a column of w, summed in int32 (int8 operands, exact) or
// f32 (bf16 operands).
//
// Operands: x is a contiguous row-major (M, K); w comes packed K-major as
// wp = w^T, a contiguous (N, K), so that both operands are read along K;
// out is a fresh row-major (M, N) int32 or f32.
//
// Bound on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8, 989 TFLOP/s
// bf16): bytes, at the probe's shapes. At M = 4096 and (K, N) = (512, 512),
// int8 moves 2 MiB of x, 256 KiB of w and 8 MiB of int32 out, 3.2 us, against
// 2.1 GOP, 1.1 us; the 4-byte output dominates. The operands fit in the
// 50 MB L2, so in a chain the HBM bound is a floor, not a tight limit.
//
// Design (mma.sync, the simple first version):
//  * The TPU's (bm, K) x (K, bn) VMEM blocks are not carried over. A CTA
//    computes a BM x BN = 64 x 128 output tile with 4 warps, each a
//    32 x 64 sub-tile (2 x 8 MMA tiles, 64 accumulator registers).
//  * Both types are staged as bytes: one K step of the MMA is 32 bytes
//    (32 int8 or 16 bf16), and the A and B fragments of m16n8k32.s8 and
//    m16n8k16.bf16 have the same byte layout. So one template, with the MMA
//    and the accumulator type as its parameter, and plain (not .trans)
//    ldmatrix for A and for the K-major B. This is why w is packed to
//    (N, K): ldmatrix.trans moves 16-bit elements and cannot transpose int8.
//  * K is staged BKB = 128 bytes at a time through a 3-stage cp.async ring.
//    Rows are padded to 144 bytes, so every ldmatrix is free of bank
//    conflicts. Chunks past K, and rows past M or N, are zero-filled by
//    cp.async (src-size 0): zeros add nothing to the sums, so K needs only
//    to be a multiple of the MMA's k.
//  * The accumulators are stored straight from registers, two per store.
// Not yet done (later work): wgmma with TMA, and an epilogue staged through
// shared memory for coalesced stores of the output that bounds the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per CTA
constexpr int BN = 128;         // output columns per CTA
constexpr int BKB = 128;        // bytes of K per stage
constexpr int ROWB = BKB + 16;  // padded shared-memory row, bytes
constexpr int STAGES = 3;
constexpr int NTHREADS = 128;
constexpr int STAGE_BYTES = (BM + BN) * ROWB;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;

struct Int8Mma {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void store2(int* p, int a, int b) {
    *reinterpret_cast<int2*>(p) = make_int2(a, b);
  }
};

struct Bf16Mma {
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Start the asynchronous copy of ROWS rows x BKB bytes, from byte kb0 of
// each row of a row-major source with KB bytes a row, into shared rows of
// ROWB bytes.
// Rows at or past nrows and chunks at or past KB are zero-filled.
template <int ROWS>
__device__ __forceinline__ void copy_tile(uint32_t dst, const uint8_t* src, int r0,
                                          int nrows, int kb0, int KB) {
  constexpr int CHUNKS = BKB / 16;
  static_assert(ROWS * CHUNKS % NTHREADS == 0, "whole steps");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NTHREADS; ++i) {
    const int u = threadIdx.x + i * NTHREADS;
    const int r = u / CHUNKS;
    const int kb = kb0 + (u - r * CHUNKS) * 16;
    const bool valid = r0 + r < nrows && kb < KB;
    const uint8_t* g = valid ? src + (long long)(r0 + r) * KB + kb : src;
    cp_async16(dst + r * ROWB + (kb - kb0), g, valid);
  }
}

template <class Op>
__global__ void __launch_bounds__(NTHREADS)
blocked_dot_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ wp,
                   typename Op::Acc* __restrict__ out, int M, int N, int KB) {
  using Acc = typename Op::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t smem = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 2 warps of 32 x 64
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // per-lane ldmatrix byte offsets within a stage: A rows of this warp;
  // B rows (the n index) of this warp, two n8 tiles per x4
  const uint32_t a_lane = (wm * 32 + (lane & 15)) * ROWB + (lane >> 4) * 16;
  const uint32_t b_lane =
      (BM + wn * 64 + (lane >> 4) * 8 + (lane & 7)) * ROWB + ((lane >> 3) & 1) * 16;

  Acc acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = Acc(0);

  const int n_k = (KB + BKB - 1) / BKB;
  auto load_stage = [&](int kt) {
    const uint32_t s = smem + (kt % STAGES) * STAGE_BYTES;
    copy_tile<BM>(s, x, m0, M, kt * BKB, KB);
    copy_tile<BN>(s + BM * ROWB, wp, n0, N, kt * BKB, KB);
  };
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < n_k) load_stage(kt);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_stages();
    __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
    if (kt + STAGES - 1 < n_k) load_stage(kt + STAGES - 1);
    cp_async_commit();

    const uint32_t s = smem + (kt % STAGES) * STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < BKB / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(a[mt], s + a_lane + mt * 16 * ROWB + ks * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, s + b_lane + np * 16 * ROWB + ks * 32);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          Op::mma(acc[mt][2 * np], a[mt], b[0], b[1]);
          Op::mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }

  // rows g and g + 8 of each 16-row tile, columns 2t and 2t + 1 of each n8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 32 + mt * 16 + g + h * 8;
      if (row >= M) continue;
      Acc* orow = out + (long long)row * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn * 64 + nt * 8 + 2 * t;
        const Acc v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (col + 1 < N && (N & 1) == 0) {
          Op::store2(orow + col, v0, v1);
        } else {
          if (col < N) orow[col] = v0;
          if (col + 1 < N) orow[col + 1] = v1;
        }
      }
    }
}

template <class Op>
int launch(const void* x, const void* wp, void* out, int M, int N, int KB,
           cudaStream_t stream) {
  auto kern = blocked_dot_kernel<Op>;
  static bool configured = false;  // set once, before any graph capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(wp),
      static_cast<typename Op::Acc*>(out), M, N, KB);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes. x is a contiguous (M, K) and wp a
// contiguous (N, K), both int8 (is_int8 = 1, out int32) or both bf16
// (is_int8 = 0, out f32); out is a contiguous (M, N). K * element size must
// be a multiple of 32 bytes (the MMA's k) and the pointers 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hsi_blocked_dot(const void* x, const void* wp, void* out, int M, int N,
                               int K, int is_int8, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int KB = is_int8 ? K : 2 * K;
  if (KB % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_int8 ? launch<Int8Mma>(x, wp, out, M, N, KB, s)
                 : launch<Bf16Mma>(x, wp, out, M, N, KB, s);
}
