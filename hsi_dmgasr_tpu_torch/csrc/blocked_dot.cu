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
// wp = w^T, a contiguous (N, K), so that both operands are read along K (the
// only layout wgmma takes for 8-bit operands); out is a fresh row-major
// (M, N) int32 or f32.
//
// Bound on this card (H100 SXM: 3.35 TB/s, 1979 TOP/s int8, 989 TFLOP/s
// bf16): bytes, at the probe's shapes. At M = 4096 and (K, N) = (512, 512),
// int8 moves 2 MiB of x, 256 KiB of w and 8 MiB of int32 out, 3.2 us, against
// 2.1 GOP, 1.1 us; the 4-byte output dominates. The operands fit in the
// 50 MB L2, so in a chain the HBM bound is a floor, not a tight limit. What
// holds a kernel back at these sizes is that each CTA has one output tile:
// its loads, its MMAs and its stores run one after the other, and the
// co-resident CTAs of an SM run them in step. The L2 re-reads (x once per
// column tile, w once per row tile) set the load phase; the 4-byte output
// sets the store phase.
//
// Design (wgmma fed by TMA):
//  * grid: 128 x 64 output tiles, column tiles fastest (neighbouring CTAs
//    share x rows in the L2). 288 threads: two consumer warpgroups, each
//    owning 64 rows of the tile, and one producer warp.
//  * both types are staged as bytes: TMA 2-D maps over x as (KB, M) and wp
//    as (KB, N), KB = K * element size, with 128-byte boxes (64 bf16 or 128
//    int8) and 128-byte swizzle. Boxes past KB, M or N are zero-filled, and
//    zeros add nothing to the sums, so K needs only to be a multiple of the
//    MMA's k. One thread of the producer warp keeps a 4-stage ring of
//    mbarrier-guarded stages loading (x: 128 rows, w: 64 rows a stage;
//    24 KB, 97 KB a CTA, two CTAs an SM).
//  * one wgmma k step is 32 bytes in both types: m64n64k32.s32.s8.s8 and
//    m64n64k16.f32.bf16.bf16, both operands K-major in shared memory, the
//    descriptors stepping 32 bytes through the swizzle row. So one template,
//    with the instruction and the accumulator type as its parameter; k steps
//    wholly past K are not issued.
//  * the epilogue: the accumulators (mma.sync's per-warp layout within each
//    16-row slab) go into a padded shared-memory tile over the ring, then
//    out as whole rows of 16-byte stores; a piece that crosses N, or rows
//    that are not 16-byte aligned (N % 4 != 0), go element by element.
//  * the maps are encoded on the host at every call (cuTensorMapEncodeTiled
//    from cudaGetDriverEntryPoint: nothing links libcuda) and passed as
//    __grid_constant__ parameters, so a kernel node captured in a CUDA graph
//    keeps its own. The entry point and the shared-memory limit are set up
//    on the first call, which is eager, before any capture.
// Why this shape: at the probe's shapes 64 x 128 and 128 x 128 tiles, a
// deeper ring at one CTA an SM, one wgmma group kept in flight across
// stages, a TMA-store epilogue, clusters of two CTAs multicasting x, and a
// persistent grid (both warpgroups on one tile, or each on its own in turn)
// were each slower somewhere.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BOX = 128;                 // bytes of K a stage: one swizzle row
constexpr int BM = 128;                  // output rows a CTA: two warpgroups
constexpr int BN = 64;                   // output columns a CTA
constexpr int STAGES = 4;
constexpr int NTHREADS = 2 * 128 + 32;   // two consumer warpgroups, a producer warp
constexpr int A_BYTES = BM * BOX;
constexpr int STAGE_BYTES = (BM + BN) * BOX;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + swizzle alignment
// the epilogue's output tile, 4-byte elements, rows padded by 8 words so
// that the 8-byte fragment writes of a half warp hit 32 distinct banks
constexpr int OUT_ROW = BN + 8;
static_assert(BM * OUT_ROW * 4 <= STAGES * STAGE_BYTES, "the output tile reuses the ring");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one 128-byte x rows box of a 2-D byte map (KB, rows) at (kb, row)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int kb, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(kb), "r"(row)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_s8_m64n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The two types differ only in the instruction and the accumulator.
struct Int8Mma {
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[BN / 2], uint64_t da, uint64_t db) {
    wgmma_s8_m64n64(d, da, db);
  }
};

struct Bf16Mma {
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
    wgmma_bf16_m64n64(d, da, db);
  }
};

__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Store 64 x BN of the shared output tile (rows OUT_ROW elements apart) at
// (m0, n0) of the row-major (M, N) out, by the 128 threads of a warpgroup:
// each row in 16-byte pieces, consecutive threads on consecutive pieces. A
// piece that crosses N, or a row that is not 16-byte aligned (N % 4 != 0),
// is stored element by element; rows past M are skipped.
template <class Acc>
__device__ __forceinline__ void store_tile(const Acc* tile, Acc* out, int m0, int n0, int M,
                                           int N, int tid) {
  constexpr int PIECES = BN / 4;
  const bool aligned = (N & 3) == 0;
#pragma unroll 4
  for (int i = 0; i < 64 * PIECES / 128; ++i) {
    const int u = tid + i * 128;
    const int r = u / PIECES, c = (u - r * PIECES) * 4;
    const int row = m0 + r, col = n0 + c;
    if (row >= M || col >= N) continue;
    const Acc* src = tile + r * OUT_ROW + c;
    Acc* dst = out + (long long)row * N + col;
    if (aligned && col + 4 <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 4 && col + e < N; ++e) dst[e] = src[e];
    }
  }
}

template <class Op>
__global__ void __launch_bounds__(NTHREADS)
blocked_dot_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, typename Op::Acc* __restrict__ out,
                   int M, int N, int KB) {
  using Acc = typename Op::Acc;
  __shared__ __align__(8) uint64_t bar_full[STAGES], bar_empty[STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (KB + BOX - 1) / BOX;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bar_full[s]), 1);
      mbar_init(smem_u32(&bar_empty[s]), 8);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the TMA loads of the K ring going
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(smem_u32(&bar_empty[s]), ((kt / STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&bar_full[s]);
        const uint32_t st = base + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load(st, &xmap, full, kt * BOX, m0);
        tma_load(st + 64 * BOX, &xmap, full, kt * BOX, m0 + 64);
        tma_load(st + A_BYTES, &wmap, full, kt * BOX, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64)
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(&bar_full[s]), (kt / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + wg * 64 * BOX;
    const uint32_t b = base + s * STAGE_BYTES + A_BYTES;
    // 32-byte k steps into the swizzle row; those wholly past K are skipped
    const int n_ks = min(BOX, KB - kt * BOX) / 32;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BOX / 32; ++ks)
      if (ks < n_ks) Op::mma(acc, sw128_desc(a + ks * 32), sw128_desc(b + ks * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&bar_empty[s]));
  }

  // ---- epilogue: the tile through shared memory (over the ring, once both
  // warpgroups are done reading it), then whole rows out with 16-byte stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_bar_sync(1, 256);
  Acc* tile = reinterpret_cast<Acc*>(smem_raw) + wg * 64 * OUT_ROW;
  // the accumulator fragment: rows g and g + 8 of the warp's 16, columns 2t
  // and 2t + 1 of each n8
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    store2(tile + (warp * 16 + g) * OUT_ROW + 8 * j + 2 * t, acc[4 * j], acc[4 * j + 1]);
    store2(tile + (warp * 16 + g + 8) * OUT_ROW + 8 * j + 2 * t, acc[4 * j + 2], acc[4 * j + 3]);
  }
  named_bar_sync(2 + wg, 128);
  store_tile(tile, out, m0 + 64 * wg, n0, M, N, tid);
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint)
// so that the library links no libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled = nullptr;

// once, on the first call (eager, before any graph capture): the driver's
// encoder and both instantiations' shared-memory limit
int configure() {
  static int rc = -1;
  if (rc >= 0) return rc;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult status;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) !=
          cudaSuccess || status != cudaDriverEntryPointSuccess)
    return rc = (int)cudaErrorSymbolNotFound;
  encode_tiled = reinterpret_cast<EncodeTiledFn>(ptr);
  cudaError_t err = cudaFuncSetAttribute(blocked_dot_kernel<Int8Mma>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(blocked_dot_kernel<Bf16Mma>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  return rc = (int)err;
}

// a row-major (rows, KB) byte matrix as a 2-D map of 128-byte x box_rows
// boxes, 128-byte swizzle, zero fill out of bounds
int encode_rows(CUtensorMap* map, const void* ptr, int KB, int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)KB, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)KB};
  const cuuint32_t box[2] = {BOX, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : (int)cudaErrorInvalidValue;
}

template <class Op>
int launch(const void* x, const void* wp, void* out, int M, int N, int KB,
           cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int rc = encode_rows(&xmap, x, KB, M, 64);
  if (!rc) rc = encode_rows(&wmap, wp, KB, N, BN);
  if (rc) return rc;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  blocked_dot_kernel<Op><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      xmap, wmap, static_cast<typename Op::Acc*>(out), M, N, KB);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes. x is a contiguous (M, K) and wp a
// contiguous (N, K), both int8 (is_int8 = 1, out int32) or both bf16
// (is_int8 = 0, out f32); out is a contiguous (M, N). K * element size must
// be a multiple of 32 bytes (the MMA's k) and the pointers 16-byte aligned.
// Returns the cudaError_t of the set-up, the map encoding or the launch
// (0 on success).
extern "C" int hsi_blocked_dot(const void* x, const void* wp, void* out, int M, int N,
                               int K, int is_int8, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int KB = is_int8 ? K : 2 * K;
  if (KB % 32 != 0) return (int)cudaErrorInvalidValue;
  const int rc = configure();
  if (rc) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_int8 ? launch<Int8Mma>(x, wp, out, M, N, KB, s)
                 : launch<Bf16Mma>(x, wp, out, M, N, KB, s);
}
