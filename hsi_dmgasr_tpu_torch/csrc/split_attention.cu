// Attention at f32 class for Hopper (sm_90a): out = softmax(q * scale . k^T) . v
// per (batch, head) on bf16 tensor cores, every f32 operand carried as a bf16
// pair hi = bf16(x), lo = bf16(x - hi) (kernels/split_attention.py).
//
// Replaces no TPU kernel: the JAX package leaves attention below its flash
// gate to XLA (hsi_dmgasr_tpu/kernels/attention.py:_xla_attention, two
// einsums and a softmax). On the card the port's first route for those
// calls was two f32 cuBLAS GEMMs (TF32 off, on no tensor core) with a scale
// pass and a softmax over the stored (S, S) logits, three times over.
//
// It computes, per (batch, head) and query row i, in three launches:
//
//   split:  q~ = q * scale (an f32 product), k, v -> hi, lo bf16 planes
//   logits: t_ij = log2(e) * (q~h.kh + q~l.kh + q~h.kl)_ij    (f32 sums)
//           for each 256-key tile: m = max_j t_ij, s = sum_j 2^(t_ij - m)
//   pv:     m_i, l_i from the tiles' (m, s); p_ij = 2^(t_ij - m_i), masked
//           to 0 for keys j >= S;  o_i = (ph.vh + pl.vh + ph.vl)_i / l_i
//
// The dropped lo.lo products and the residues past hi + lo are each below
// 2^-17 of |a| |b| (an error of about 3 x 2^-18 of sum |q||k| on a logit
// and of sum |p||v| on an output); the sums run in f32. Rows and keys past
// S inside each head are zero-filled by the tensor maps and masked.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): operations.
// At the r3 UNet's 64^2 level (B*H = 9, S = 4096, D = 512) a call is
// 4 * 9 * 4096^2 * 512 = 309 GFLOP counted once, 0.31 ms at the bf16 peak;
// the three products make it 0.94 ms. Its bytes: q, k, v and out in f32
// (0.30 GB), the split planes (0.23 GB written, read again from L2), the
// stored logits (0.60 GB written and read once), about 1.4 GB or 0.42 ms
// at the card's bandwidth, which the MMAs of other CTAs overlap.
//
// Design (two GEMMs with the logits between them; see PERF.md for what
// else was weighed): both GEMMs are the blocked dot's machinery
// (blocked_dot.cu): a ring of mbarrier-guarded stages that one thread of a
// producer warp fills with TMA loads, two consumer warpgroups of 64 rows
// each running wgmma on what has landed, 288 threads, one CTA an SM.
//  * split_kernel writes the six planes (q~, k, v) x (hi, lo) as one
//    (6, B*H, S, D) bf16 tensor: each GEMM then moves bf16 tiles only, and
//    no consumer thread converts an operand. One 3-D tensor map over it,
//    (D, S, 6 B*H), 128-byte swizzle, 64-column boxes.
//  * logits_kernel: a 128-query x 256-key tile, D in 64-column K steps
//    through a 2-stage ring of 96 KB (q~ hi, lo; k hi, lo), three
//    m64n256k16 products a k16 step with both operands K-major in shared
//    memory. Its epilogue scales by log2(e), stores the f32 logits from the
//    accumulators and each row's (max, sum of 2^(t - max)) over its 256
//    keys, so the softmax needs no pass of its own.
//  * pv_kernel: a 128-query x 256-column output tile, keys in 32-key steps
//    through a 4-stage ring of 48 KB (the logits' 128 x 32 f32 tile; v hi,
//    lo as 64-column boxes, MN-major). Each warp reads its 16 rows' logits
//    from shared memory into registers, exponentiates against the row's
//    max, splits p into hi + lo A fragments and issues three
//    m64n256k16 products; the other warpgroup's MMAs overlap that work.
//    The epilogue divides by l and stores f32 rows of (B, S, H, D).
//
// What bounds it: the operands' traffic from L2 as much as the MMAs. Both
// GEMMs read about 3.5 GB a call from L2 at the r3 shape (each 128 x 256
// tile's q~ and k, or logits and v, hi and lo), 4.9 and 4.3 TB/s at their
// measured times. Measured on an H100 at (9, 4096, 512), ms (split, logits, p.v):
// this design 0.152, 0.719, 0.799 (1.664 in all; 0.201 at S = 1024);
// logits with only two products 0.614 and without its epilogue 0.636 (so
// neither the MMAs nor the stores alone set it); p.v without the
// exponentials and splits 0.668 (the other warpgroup hides most of them);
// p.v on 128-column tiles at two CTAs an SM 1.123, with 3 stages 0.788;
// logits on 128-key tiles with 3 stages 0.770 (0.064 against 0.072 at
// S = 1024). Not built: a flash-style kernel (the logits never stored)
// can give a CTA only 64 query rows at D = 512 (a 64 x 512 f32 output is
// two warpgroups' registers), so every CTA streams all of k and v: about
// 9.3 GB from L2 a call against these two GEMMs' 7.0, and an exchange of
// S = Q K^T halves through shared memory at every key tile; two column
// slices that each recompute Q K^T cost 1.5 x the MMAs and 13.8 GB.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_stage.cuh"
#include "wgmma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_BIG = -1e30f;
constexpr int CB = 64;                  // bf16 columns of a 128-byte swizzle row (one box)
constexpr int THREADS = 2 * 128 + 32;   // two consumer warpgroups, a producer warp

// logits_kernel: 128 queries x 256 keys, K steps of 64 columns of D
constexpr int L_BM = 128, L_BN = 256, L_STAGES = 2;
constexpr int L_Q_BYTES = L_BM * 128;                   // q~ hi or lo of a stage
constexpr int L_K_BYTES = L_BN * 128;                   // k hi or lo of a stage
constexpr int L_STAGE = 2 * (L_Q_BYTES + L_K_BYTES);    // 96 KB
constexpr int L_SMEM = L_STAGES * L_STAGE + 1024;       // + swizzle alignment

// pv_kernel: 128 queries x 256 output columns, K steps of 32 keys
constexpr int P_BM = 128, P_BN = 256, P_BK = 32, P_STAGES = 4;
constexpr int P_L_BYTES = P_BM * P_BK * 4;              // the logits' f32 tile
constexpr int P_V_BYTES = P_BK * P_BN * 2;              // v hi or lo: 4 boxes of 64 columns
constexpr int P_STAGE = P_L_BYTES + 2 * P_V_BYTES;      // 48 KB
constexpr int P_SMEM = P_STAGES * P_STAGE + 1024;
static_assert(L_SMEM <= 232448 && P_SMEM <= 232448, "shared memory of one CTA");

struct Params {
  const float* q;          // (B, S, H, D) views, unit stride along D
  const float* k;
  const float* v;
  float* o;                // (B, S, H, D) contiguous
  __nv_bfloat16* planes;   // (6, B*H, S, D): q~ hi, q~ lo, k hi, k lo, v hi, v lo
  float* logits;           // (B*H, S, SP), log2(e) units
  float2* stats;           // (B*H, S, NT): (max, sum of 2^(t - max)) per 256-key tile
  long long qs_b, qs_s, qs_h;
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  int B, S, H, D, SP, NT;
  float scale;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// one box of a 3-D map at (c0, c1, c2)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 8);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// a consumer warp is done reading stage s
__device__ __forceinline__ void release(uint64_t* empty, int s) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(smem_u32(&empty[s]));
}

// d (+)= A B, m64n256k16, both operands K-major in shared memory; scale_d 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n256k16, A (this warp's 16 rows, mma.sync's A fragment) from
// registers, B MN-major in shared memory (its rows are the k index)
__device__ __forceinline__ void wgmma_m64n256k16_rs_mn(float (&d)[128], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------- split

// One thread per 8 elements of a (which, b*H + h, s) row of D: the strided
// f32 view (q times scale), as hi and lo bf16 rows of the planes.
__global__ void __launch_bounds__(256) split_kernel(const Params p) {
  const int per_row = p.D / 8;
  const long long rows = (long long)p.B * p.H * p.S;
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= 3 * rows * per_row) return;
  const long long row = u / per_row;
  const int c = (int)(u - row * per_row) * 8;
  const int which = (int)(row / rows);
  const long long r = row - which * rows;
  const int bh = (int)(r / p.S), s = (int)(r - (long long)bh * p.S);
  const int b = bh / p.H, h = bh - b * p.H;
  const float* src;
  float mul = 1.f;
  if (which == 0) {
    src = p.q + b * p.qs_b + s * p.qs_s + h * p.qs_h;
    mul = p.scale;
  } else if (which == 1) {
    src = p.k + b * p.ks_b + s * p.ks_s + h * p.ks_h;
  } else {
    src = p.v + b * p.vs_b + s * p.vs_s + h * p.vs_h;
  }
  const float4 x0 = __ldg(reinterpret_cast<const float4*>(src + c));
  const float4 x1 = __ldg(reinterpret_cast<const float4*>(src + c + 4));
  uint4 hi, lo;
  split_bf16(x0.x * mul, x0.y * mul, hi.x, lo.x);
  split_bf16(x0.z * mul, x0.w * mul, hi.y, lo.y);
  split_bf16(x1.x * mul, x1.y * mul, hi.z, lo.z);
  split_bf16(x1.z * mul, x1.w * mul, hi.w, lo.w);
  *reinterpret_cast<uint4*>(p.planes + ((2 * which) * rows + r) * p.D + c) = hi;
  *reinterpret_cast<uint4*>(p.planes + ((2 * which + 1) * rows + r) * p.D + c) = lo;
}

// ---------------------------------------------------------------- logits

__global__ void __launch_bounds__(THREADS, 1)
logits_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const Params p) {
  __shared__ __align__(8) uint64_t bar_full[L_STAGES], bar_empty[L_STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms
  const int n0 = blockIdx.x * L_BN, m0 = blockIdx.y * L_BM, bh = blockIdx.z;
  const int BH = p.B * p.H, S = p.S;
  const int n_k = p.D / CB;
  const int wg = threadIdx.x / 128;
  init_ring(bar_full, bar_empty, L_STAGES);

  if (wg == 2) {
    // ---- producer: one thread keeps the TMA loads of the ring going
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % L_STAGES;
        mbar_wait(smem_u32(&bar_empty[s]), ((kt / L_STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&bar_full[s]);
        const uint32_t st = base + s * L_STAGE;
        mbar_expect_tx(full, L_STAGE);
        tma_load(st, &qmap, full, kt * CB, m0, bh);
        tma_load(st + L_Q_BYTES, &qmap, full, kt * CB, m0, BH + bh);
        tma_load(st + 2 * L_Q_BYTES, &kmap, full, kt * CB, n0, 2 * BH + bh);
        tma_load(st + 2 * L_Q_BYTES + L_K_BYTES, &kmap, full, kt * CB, n0, 3 * BH + bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [64 wg, 64 wg + 64) of the tile
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[L_BN / 2];
#pragma unroll
  for (int i = 0; i < L_BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % L_STAGES;
    mbar_wait(smem_u32(&bar_full[s]), (kt / L_STAGES) & 1);
    const uint32_t qh = base + s * L_STAGE + wg * 64 * 128, ql = qh + L_Q_BYTES;
    const uint32_t kh = base + s * L_STAGE + 2 * L_Q_BYTES, kl = kh + L_K_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CB / 16; ++kk) {
      const uint32_t off = kk * 32;   // 16 columns into the swizzle row
      wgmma_m64n256k16_ss(acc, sw128_desc(qh + off), sw128_desc(kh + off), 1);   // hi hi
      wgmma_m64n256k16_ss(acc, sw128_desc(ql + off), sw128_desc(kh + off), 1);   // lo hi
      wgmma_m64n256k16_ss(acc, sw128_desc(qh + off), sw128_desc(kl + off), 1);   // hi lo
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(bar_empty, s);
  }

  // ---- epilogue: rows g and g + 8 of the warp's 16; n8 block j holds
  // columns 8 j + 2 t, + 1 in acc[4 j + 2 r], acc[4 j + 2 r + 1]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wg * 64 + warp * 16 + g + 8 * r;
    float mx = NEG_BIG;
#pragma unroll
    for (int j = 0; j < L_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = acc[4 * j + 2 * r + e] * LOG2E;
        acc[4 * j + 2 * r + e] = x;
        if (n0 + 8 * j + 2 * t + e < S) mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < L_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (n0 + 8 * j + 2 * t + e < S) sum += ex2(acc[4 * j + 2 * r + e] - mx);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (row < S) {
      float* lrow = p.logits + ((long long)bh * S + row) * p.SP + n0 + 2 * t;
      // a pair starting before S ends inside the row's SP (a multiple of 4)
#pragma unroll
      for (int j = 0; j < L_BN / 8; ++j)
        if (n0 + 8 * j + 2 * t < S)
          *reinterpret_cast<float2*>(lrow + 8 * j) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      if (t == 0) p.stats[((long long)bh * S + row) * p.NT + blockIdx.x] = make_float2(mx, sum);
    }
  }
}

// ---------------------------------------------------------------- p . v

__global__ void __launch_bounds__(THREADS, 1)
pv_kernel(const __grid_constant__ CUtensorMap lmap, const __grid_constant__ CUtensorMap vmap,
          const Params p) {
  __shared__ __align__(8) uint64_t bar_full[P_STAGES], bar_empty[P_STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms
  const unsigned char* sbase = smem_raw + (base - smem_u32(smem_raw));
  const int n0 = blockIdx.x * P_BN, m0 = blockIdx.y * P_BM, bh = blockIdx.z;
  const int BH = p.B * p.H, S = p.S;
  const int n_k = (S + P_BK - 1) / P_BK;
  const int ncb = min(P_BN, p.D - n0) / CB;   // v boxes a stage: columns past D are not loaded
  const int wg = threadIdx.x / 128;
  init_ring(bar_full, bar_empty, P_STAGES);

  if (wg == 2) {
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % P_STAGES;
        mbar_wait(smem_u32(&bar_empty[s]), ((kt / P_STAGES) & 1) ^ 1);
        const uint32_t full = smem_u32(&bar_full[s]);
        const uint32_t st = base + s * P_STAGE;
        mbar_expect_tx(full, P_L_BYTES + 2 * ncb * P_BK * 128);
        tma_load(st, &lmap, full, kt * P_BK, m0, bh);
        for (int c = 0; c < ncb; ++c) {
          tma_load(st + P_L_BYTES + c * P_BK * 128, &vmap, full, n0 + c * CB, kt * P_BK,
                   4 * BH + bh);
          tma_load(st + P_L_BYTES + P_V_BYTES + c * P_BK * 128, &vmap, full, n0 + c * CB,
                   kt * P_BK, 5 * BH + bh);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lrow0 = wg * 64 + warp * 16 + g;   // this thread's first row in the tile

  // the rows' max and 1 / l from the logits kernel's per-tile statistics
  float mrow[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + lrow0 + 8 * r;
    mrow[r] = 0.f;
    inv[r] = 0.f;
    if (row < S) {
      const float2* st = p.stats + ((long long)bh * S + row) * p.NT;
      float m = NEG_BIG;
      for (int i = 0; i < p.NT; ++i) m = fmaxf(m, st[i].x);
      float l = 0.f;
      for (int i = 0; i < p.NT; ++i) l += st[i].y * ex2(st[i].x - m);
      mrow[r] = m;
      inv[r] = 1.f / l;
    }
  }

  float acc[P_BN / 2];
#pragma unroll
  for (int i = 0; i < P_BN / 2; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % P_STAGES;
    mbar_wait(smem_u32(&bar_full[s]), (kt / P_STAGES) & 1);
    const unsigned char* lt = sbase + s * P_STAGE;
    // P as hi and lo A fragments: register i holds row g + 8 (i & 1), keys
    // 16 kk + 2 t + 8 (i >> 1), + 1; the tile's 128-byte rows are swizzled
    // in 16-byte chunks by row & 7 (= g)
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i & 1, key = 16 * kk + 2 * t + 8 * (i >> 1);
        const int lr = lrow0 + 8 * r;
        const float2 x = *reinterpret_cast<const float2*>(
            lt + lr * 128 + (((key >> 2) ^ g) << 4) + (key & 3) * 4);
        const int col = kt * P_BK + key;
        const float p0 = col < S ? ex2(x.x - mrow[r]) : 0.f;
        const float p1 = col + 1 < S ? ex2(x.y - mrow[r]) : 0.f;
        split_bf16(p0, p1, ah[kk][i], al[kk][i]);
      }
    const uint32_t vh = base + s * P_STAGE + P_L_BYTES, vl = vh + P_V_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dh = sw128_desc(vh + kk * 16 * 128, P_BK * 128);
      const uint64_t dl = sw128_desc(vl + kk * 16 * 128, P_BK * 128);
      wgmma_m64n256k16_rs_mn(acc, ah[kk], dh);   // p_hi v_hi
      wgmma_m64n256k16_rs_mn(acc, al[kk], dh);   // p_lo v_hi
      wgmma_m64n256k16_rs_mn(acc, ah[kk], dl);   // p_hi v_lo
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(ah[kk][i]), "+r"(al[kk][i]) :: "memory");
    release(bar_empty, s);
  }

  // ---- out = O / l, f32 rows of (B, S, H, D)
  const int b = bh / p.H, h = bh - b * p.H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + lrow0 + 8 * r;
    if (row >= S) continue;
    float* orow = p.o + (((long long)b * S + row) * p.H + h) * p.D + n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < P_BN / 8; ++j)
      if (n0 + 8 * j < p.D)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
  }
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint)
// so that the library links no libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled = nullptr;

// once, on the first call: the driver's encoder and the kernels'
// shared-memory limits
int configure() {
  static int rc = -1;
  if (rc >= 0) return rc;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult status;
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) !=
          cudaSuccess || status != cudaDriverEntryPointSuccess)
    return rc = (int)cudaErrorSymbolNotFound;
  encode_tiled = reinterpret_cast<EncodeTiledFn>(ptr);
  cudaError_t err = cudaFuncSetAttribute(logits_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P_SMEM);
  return rc = (int)err;
}

// a 3-D (inner, rows, planes) tensor as a map of (box_inner, box_rows, 1)
// boxes, 128-byte swizzle; rows past `rows` zero-fill inside each plane
int encode3d(CUtensorMap* map, CUtensorMapDataType type, int esize, void* ptr,
             long long inner, long long rows, long long planes, int box_inner, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)(inner * esize), (cuuint64_t)(rows * inner * esize)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled(map, type, 3, ptr, dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : (int)cudaErrorInvalidValue;
}

int run(const Params& p, int phases, cudaStream_t stream) {
  const int BH = p.B * p.H;
  if (phases & 1) {
    const long long work = 3LL * BH * p.S * (p.D / 8);
    split_kernel<<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    CUtensorMap qmap, kmap;
    int rc = encode3d(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.planes, p.D, p.S, 6LL * BH,
                      CB, L_BM);
    if (!rc) rc = encode3d(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.planes, p.D, p.S,
                           6LL * BH, CB, L_BN);
    if (rc) return rc;
    dim3 grid((p.S + L_BN - 1) / L_BN, (p.S + L_BM - 1) / L_BM, BH);
    logits_kernel<<<grid, THREADS, L_SMEM, stream>>>(qmap, kmap, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 4) {
    CUtensorMap lmap, vmap;
    int rc = encode3d(&lmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.logits, p.SP, p.S, BH, P_BK,
                      P_BM);
    if (!rc) rc = encode3d(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.planes, p.D, p.S,
                           6LL * BH, CB, P_BK);
    if (rc) return rc;
    dim3 grid((p.D + P_BN - 1) / P_BN, (p.S + P_BM - 1) / P_BM, BH);
    pv_kernel<<<grid, THREADS, P_SMEM, stream>>>(lmap, vmap, p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Plain C entry, bound with ctypes. q, k, v: f32 (B, S, H, D) views with
// unit stride along D, rows 16-byte aligned (strides in elements); o a
// contiguous f32 (B, S, H, D). Scratch the caller allocates: planes, a
// (6, B*H, S, D) bf16 tensor; logits, a (B*H, S, SP) f32 one with SP the
// smallest multiple of 4 at or above S; stats, a (B*H, S, NT) float2 one,
// NT = ceil(S / 256). D % 64 == 0. phases selects what runs: 1 the split,
// 2 the logits, 4 p . v (7, all three, is what the wrapper launches; a
// later phase reads what an earlier call of the earlier ones wrote).
// Returns the cudaError_t of the set-up, a map's encoding or the first
// launch that failed (0 on success).
extern "C" int hsi_split_attention(
    const float* q, const float* k, const float* v, float* o,
    long long qs_b, long long qs_s, long long qs_h,
    long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h,
    int B, int S, int H, int D, float scale, void* planes, void* logits, void* stats,
    int phases, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % CB || B * H > 65535 ||
      (S + L_BM - 1) / L_BM > 65535)
    return (int)cudaErrorInvalidValue;
  const int rc = configure();
  if (rc) return rc;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.planes = static_cast<__nv_bfloat16*>(planes);
  p.logits = static_cast<float*>(logits);
  p.stats = static_cast<float2*>(stats);
  p.qs_b = qs_b;
  p.qs_s = qs_s;
  p.qs_h = qs_h;
  p.ks_b = ks_b;
  p.ks_s = ks_s;
  p.ks_h = ks_h;
  p.vs_b = vs_b;
  p.vs_s = vs_s;
  p.vs_h = vs_h;
  p.B = B;
  p.S = S;
  p.H = H;
  p.D = D;
  p.SP = (S + 3) / 4 * 4;
  p.NT = (S + L_BN - 1) / L_BN;
  p.scale = scale;
  return run(p, phases, static_cast<cudaStream_t>(stream));
}
