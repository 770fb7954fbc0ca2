// Flash attention for Hopper (sm_90a): softmax(q * scale . k^T) . v,
// streamed over K/V tiles so the (S, S) logits never reach device memory.
//
// Replaces the TPU kernel hsi_dmgasr_tpu/kernels/flash_attention.py:
// flash_attention / _flash_kernel (the pl.pallas_call at :119). It computes
// what _flash_kernel computes, per (batch, head) and query row:
//
//   s_j = bf16(q * scale) . bf16(k_j)           (f32 accumulation)
//   s_j = -1e30 for keys j >= S                 (the ragged tail, masked)
//   running max m, running sum l of exp(s_j - m) in f32, rescaled by
//   exp(m_old - m_new) at every K/V tile;  o += bf16(p) . bf16(v)
//   out = o / l
//
// Operands: q, k, v are (B, S, H, D) f32, read with their own strides
// (they are the strided q/k/v views of the UNet's qkv split); out is a
// fresh contiguous (B, S, H, D) f32 tensor.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): operations.
// At the main path's shape (B*H = 9, S = 16384, D = 256) one launch is
// 4 * 9 * 16384^2 * 256 = 2.47 TFLOP, 2.50 ms at the bf16 peak, against
// ~0.6 GB of f32 q, k, v and out, 0.18 ms. What keeps a kernel from that
// bound is feeding the tensor cores: mma.sync needs every warp to read its
// K and V tiles through ldmatrix (about 16 FLOP per byte of shared memory,
// half the peak at best), and the 2.4e9 exponentials share the SM with
// the MMAs.
//
// Design at D = 128 and 256 (the main path's D = 256; FlashAttention-3's
// shape without its ping-pong):
//  * a prepass (to_bf16_kernel) writes bf16(q * scale), bf16(k) and bf16(v)
//    once into a contiguous (3, B*H, S, D) bf16 scratch that the caller
//    allocates: ~0.68 GB moved at the main path's shape, ~0.2 ms. The main
//    kernel then moves bf16 tiles only, and no thread rounds or copies.
//  * grid: query tiles of 128 rows x (B*H); 384 threads in three
//    warpgroups. One thread of the first issues TMA loads: the CTA's Q once
//    and 64-key K and V tiles into a ring of mbarrier-guarded stages (2 at
//    D = 256, 4 at D = 128: 192 and 160 KB of shared memory, one CTA per
//    SM). The tensor map is 3-D over (D, S, 3 * B * H), so rows past S
//    zero-fill inside each head, and 128-byte swizzled: each 64 x D tile
//    lands as D / 64 boxes of 64 columns, the layout wgmma reads.
//  * the other two warpgroups each own 64 query rows, with setmaxnreg
//    moving registers to them (240 each, 24 for the producer): the 64 x D
//    f32 output is 128 registers a thread at D = 256. S = Q K^T is
//    wgmma.m64n64k16 with both operands K-major in shared memory; P goes
//    from the S accumulators (mma.sync's per-warp layout) to bf16 A
//    fragments in registers, and O += P V is wgmma.m64nDk16 with V read
//    MN-major (its rows are keys). wgmma reads each B tile once per 64
//    rows, not once per 16. The online softmax runs between the two
//    GEMMs; the other warpgroup's GEMMs are what overlaps it. exp is
//    ex2.approx on log2e-scaled logits.
// D = 384 and 512 (no main path launches them) keep the first design,
// flash_attention_kernel on mma.sync: f32 q, k, v read in place, K/V tiles
// of 32 keys staged in f32 one tile ahead and rounded to bf16 in shared
// memory, and two column slices that each recompute Q K^T (a 16 x D f32
// accumulator per warp would not fit in registers). dispatch() picks the
// body by D; neither falls back to the other.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;          // keys per K/V tile
constexpr int PAD = 8;          // bf16 row padding: conflict-free ldmatrix
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// per head dim: output columns per CTA and warps per CTA (shared memory)
template <int D>
struct Shape {
  static constexpr int DV = D / ((D + 255) / 256);
  static constexpr int NW = D <= 384 ? 8 : 4;
  static constexpr int NTHREADS = 32 * NW;
  static constexpr int BQ = 16 * NW;
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;                      // (B, S, H, D) contiguous
  __nv_bfloat16* scratch;        // (3, B*H, S, D): bf16(q * scale), bf16(k), bf16(v)
  long long qs_b, qs_s, qs_h;    // element strides (the d stride is 1)
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  int B, S, H;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Q: rows [r0, r0 + ROWS) x NC columns of a row-strided source into shared
// memory as bf16(x * scale), row stride NC + PAD; rows at or past S are zero.
template <int NC, int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_scaled(__nv_bfloat16* dst, const float* src,
                                             long long row_stride, int r0, int S,
                                             float scale) {
  constexpr int PER_ROW = NC / 4;
  static_assert(ROWS * PER_ROW % NTHREADS == 0, "whole steps");
#pragma unroll 4
  for (int i = 0; i < ROWS * PER_ROW / NTHREADS; ++i) {
    const int u = threadIdx.x + i * NTHREADS;
    const int r = u / PER_ROW;
    const int c = (u - r * PER_ROW) * 4;
    uint2 w = make_uint2(0u, 0u);
    if (r0 + r < S) {
      const float4 x = load4(src + (long long)(r0 + r) * row_stride + c);
      w.x = pack_bf16(x.x * scale, x.y * scale);
      w.y = pack_bf16(x.z * scale, x.w * scale);
    }
    *reinterpret_cast<uint2*>(dst + r * (NC + PAD) + c) = w;
  }
}

// K/V: issue the copy of BK rows x NC columns, in f32, into a dense
// [BK][NC] staging tile; rows at or past S are zero-filled.
template <int NC, int NTHREADS>
__device__ __forceinline__ void copy_tile_async(float* dst, const float* src,
                                                long long row_stride, int r0, int S) {
  constexpr int VEC = 4;
  constexpr int PER_ROW = NC / VEC;
  static_assert(BK * PER_ROW % NTHREADS == 0, "whole steps");
#pragma unroll
  for (int i = 0; i < BK * PER_ROW / NTHREADS; ++i) {
    const int u = threadIdx.x + i * NTHREADS;
    const int r = u / PER_ROW;
    const int c = (u - r * PER_ROW) * VEC;
    const bool valid = r0 + r < S;
    cp_async16(dst + r * NC + c, src + (long long)(valid ? r0 + r : 0) * row_stride + c, valid);
  }
}

// round a staged [BK][NC] tile to bf16 rows of stride NC + PAD
template <int NC, int NTHREADS>
__device__ __forceinline__ void round_tile(__nv_bfloat16* dst, const float* src) {
  constexpr int PER_ROW = NC / 4;
  static_assert(BK * PER_ROW % NTHREADS == 0, "whole steps");
#pragma unroll
  for (int i = 0; i < BK * PER_ROW / NTHREADS; ++i) {
    const int u = threadIdx.x + i * NTHREADS;
    const int r = u / PER_ROW;
    const int c = (u - r * PER_ROW) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * NC + c);
    *reinterpret_cast<uint2*>(dst + r * (NC + PAD) + c) =
        make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

template <int D>
constexpr int smem_bytes() {
  using Sh = Shape<D>;
  return (Sh::BQ * (D + PAD) + BK * (D + PAD) + BK * (Sh::DV + PAD)) * 2 +
         BK * (D + Sh::DV) * 4;
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::NTHREADS)
flash_attention_kernel(const Params p) {
  using Sh = Shape<D>;
  constexpr int DV = Sh::DV, BQ = Sh::BQ, NTHREADS = Sh::NTHREADS;
  constexpr int QS = D + PAD;   // row stride of the Q and K tiles
  constexpr int VS = DV + PAD;  // row stride of the V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qsm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ksm = qsm + BQ * QS;
  __nv_bfloat16* vsm = ksm + BK * QS;
  float* kst = reinterpret_cast<float*>(vsm + BK * VS);   // f32 staging
  float* vst = kst + BK * D;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.y * DV;
  const int bh = blockIdx.z;
  const int b = bh / p.H, h = bh - b * p.H;
  const int S = p.S;

  const float* qg = p.q + b * p.qs_b + h * p.qs_h;
  const float* kg = p.k + b * p.ks_b + h * p.ks_h;
  const float* vg = p.v + b * p.vs_b + h * p.vs_h + c0;

  copy_tile_async<D, NTHREADS>(kst, kg, p.ks_s, 0, S);
  copy_tile_async<DV, NTHREADS>(vst, vg, p.vs_s, 0, S);
  cp_async_commit();
  stage_scaled<D, BQ, NTHREADS>(qsm, qg, p.qs_s, q0, S, p.scale);

  // per-lane ldmatrix byte offsets: A (Q rows of this warp), B (K rows as
  // the n index), B^T (V rows as the k index)
  const uint32_t q_s = static_cast<uint32_t>(__cvta_generic_to_shared(qsm));
  const uint32_t k_s = static_cast<uint32_t>(__cvta_generic_to_shared(ksm));
  const uint32_t v_s = static_cast<uint32_t>(__cvta_generic_to_shared(vsm));
  const uint32_t a_lane = 2u * ((warp * 16 + (lane & 15)) * QS + (lane >> 4) * 8);
  const uint32_t b_lane = 2u * (((lane >> 4) * 8 + (lane & 7)) * QS + ((lane >> 3) & 1) * 8);
  const uint32_t v_lane = 2u * (((lane & 7) + ((lane >> 3) & 1) * 8) * VS + (lane >> 4) * 8);

  float o[DV / 8][4];
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  // rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // thread's share of the running sum
  float m[2] = {NEG_BIG, NEG_BIG};
  float l[2] = {0.f, 0.f};

  const int n_tiles = (S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    cp_async_wait_all();
    __syncthreads();  // tile j staged; the MMAs of tile j - 1 are done
    round_tile<D, NTHREADS>(ksm, kst);
    round_tile<DV, NTHREADS>(vsm, vst);
    __syncthreads();  // bf16 tile j ready; the staging buffers are free
    if (j + 1 < n_tiles) {
      copy_tile_async<D, NTHREADS>(kst, kg, p.ks_s, k0 + BK, S);
      copy_tile_async<DV, NTHREADS>(vst, vg, p.vs_s, k0 + BK, S);
      cp_async_commit();
    }

    // ---- S = Q K^T: 16 rows x BK keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < D; kd += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + a_lane + 2u * kd);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4(bb, k_s + b_lane + 2u * (np * 16 * QS + kd));
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // ---- online softmax (log2 units), keys at or past S masked
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const float x = col < S ? s[nt][e] * LOG2E : NEG_BIG;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(s[nt][e] - m[e >> 1]);
        l[e >> 1] += pe;
        s[nt][e] = pe;
      }
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // ---- O += bf16(P) V over this CTA's DV columns
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int np = 0; np < DV / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, v_s + v_lane + 2u * (kk * 16 * VS + np * 16));
        mma_bf16(o[2 * np], pa, bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], pa, bb[2], bb[3]);
      }
    }
  }

  // ---- out = O / l
  float* og = p.o;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row < S) {
      float* orow = og + (((long long)b * S + row) * p.H + h) * D + c0 + 2 * t;
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt)
        store2(orow + nt * 8, o[nt][2 * r] / l[r], o[nt][2 * r + 1] / l[r]);
    }
  }
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
  using Sh = Shape<D>;
  constexpr int smem = smem_bytes<D>();
  static_assert(smem <= 232448, "shared memory of one CTA");
  auto kern = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + Sh::BQ - 1) / Sh::BQ, D / Sh::DV, p.B * p.H);
  kern<<<grid, Sh::NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- prepass

// One thread per 8 elements of a (which, b*H + h, s) row of D: reads the
// strided f32 view, writes bf16 (q times scale) into the contiguous scratch.
template <int D>
__global__ void __launch_bounds__(256) to_bf16_kernel(const Params p) {
  constexpr int PER_ROW = D / 8;
  const long long rows = (long long)p.B * p.H * p.S;
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= 3 * rows * PER_ROW) return;
  const long long row = u / PER_ROW;
  const int c = (int)(u - row * PER_ROW) * 8;
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
  const float4 x0 = load4(src + c), x1 = load4(src + c + 4);
  uint4 w;
  w.x = pack_bf16(x0.x * mul, x0.y * mul);
  w.y = pack_bf16(x0.z * mul, x0.w * mul);
  w.z = pack_bf16(x1.x * mul, x1.y * mul);
  w.w = pack_bf16(x1.z * mul, x1.w * mul);
  *reinterpret_cast<uint4*>(p.scratch + row * D + c) = w;
}

// ------------------------------------ D = 128, 256: wgmma fed by TMA (sm_90a)

constexpr int WG_BQ = 128;       // query rows per CTA: two consumer warpgroups of 64
constexpr int WG_BK = 64;        // keys per K/V stage
constexpr int WG_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int CB = 64;           // bf16 columns per 128-byte swizzle row (one TMA box)

template <int D>
struct WgShape {
  static constexpr int NCB = D / CB;                   // column blocks of a tile
  static constexpr int STAGES = D == 128 ? 4 : 2;      // K/V ring depth
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  static constexpr int KV_BYTES = WG_BK * D * 2;       // one K or one V tile
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;   // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// one 64 x 64 bf16 box of the 3-D map (D, S, 3 * B * H) at (c0, c1, c2)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle. K-major (Q, K): 8-row
// groups 1024 bytes apart, the leading offset unused. MN-major (V): 64-column
// blocks `lead` bytes apart, 8-key groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep reads and writes of wgmma accumulators on their side of a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, db);
  else wgmma_m64n256k16_rs(o, a, db);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tmap, const Params p) {
  using Sh = WgShape<D>;
  constexpr int ST = Sh::STAGES;
  __shared__ __align__(8) uint64_t bar_q, bar_full[ST], bar_empty[ST];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // swizzle atoms
  const uint32_t q_s = base;                                      // [NCB][128 rows][64]
  auto k_s = [&](int s) { return base + Sh::Q_BYTES + s * 2 * Sh::KV_BYTES; };  // [NCB][64][64]
  auto v_s = [&](int s) { return k_s(s) + Sh::KV_BYTES; };

  const int S = p.S;
  const int q0 = blockIdx.x * WG_BQ;
  const int bh = blockIdx.y;
  const int BH = p.B * p.H;
  const int n_tiles = (S + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar_q), 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(smem_u32(&bar_full[s]), 1);
      mbar_init(smem_u32(&bar_empty[s]), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads of the K/V ring going
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(smem_u32(&bar_q), Sh::Q_BYTES);
      for (int c = 0; c < Sh::NCB; ++c)
        for (int half = 0; half < 2; ++half)
          tma_load(q_s + c * (WG_BQ * 128) + half * (64 * 128), &tmap, smem_u32(&bar_q),
                   c * CB, q0 + half * 64, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        mbar_wait(smem_u32(&bar_empty[s]), ((j / ST) & 1) ^ 1);
        const uint32_t full = smem_u32(&bar_full[s]);
        mbar_expect_tx(full, 2 * Sh::KV_BYTES);
        for (int c = 0; c < Sh::NCB; ++c) {
          tma_load(k_s(s) + c * (WG_BK * 128), &tmap, full, c * CB, j * WG_BK, BH + bh);
          tma_load(v_s(s) + c * (WG_BK * 128), &tmap, full, c * CB, j * WG_BK, 2 * BH + bh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows [64 cw, 64 cw + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t qa = q_s + cw * (64 * 128);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sacc[WG_BK / 2];
#pragma unroll
    for (int i = 0; i < WG_BK / 2; ++i) sacc[i] = 0.f;
    // rows g and g + 8 of the warp's 16: running max (log2 units) and this
    // thread's share of the running sum
    float m[2] = {NEG_BIG, NEG_BIG};
    float l[2] = {0.f, 0.f};

    mbar_wait(smem_u32(&bar_q), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST;
      const int k0 = j * WG_BK;
      mbar_wait(smem_u32(&bar_full[s]), (j / ST) & 1);

      // ---- S = Q K^T: 64 rows x 64 keys, D / 16 steps, both operands K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns into the swizzle row
        wgmma_m64n64k16_ss(sacc,
                           sw128_desc(qa + (kk / 4) * (WG_BQ * 128) + off, 16),
                           sw128_desc(k_s(s) + (kk / 4) * (WG_BK * 128) + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // ---- online softmax (log2 units), keys at or past S masked
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < WG_BK / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + 2 * t + (i & 1);
        const float x = col < S ? sacc[i] * LOG2E : NEG_BIG;
        sacc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      // P to bf16 A fragments: the accumulator layout of 8 keys per 4
      // registers is mma.sync's, so keys [16 kk, 16 kk + 16) make pa[kk]
      uint32_t pa[WG_BK / 16][4];
#pragma unroll
      for (int nt = 0; nt < WG_BK / 8; ++nt) {
        float pe[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pe[e] = ex2(sacc[4 * nt + e] - m[e >> 1]);
          l[e >> 1] += pe[e];
        }
        pa[nt >> 1][(nt & 1) * 2] = pack_bf16(pe[0], pe[1]);
        pa[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // ---- O += P V: A from registers, V MN-major (its rows are keys)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma_pv<D>(o, pa[kk], sw128_desc(v_s(s) + kk * 16 * 128, WG_BK * 128));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i]) :: "memory");
      mbar_arrive(smem_u32(&bar_empty[s]));
    }

    // ---- out = O / l
    const int b = bh / p.H, h = bh - b * p.H;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float inv = 1.f / l[r];
      const int row = q0 + cw * 64 + warp * 16 + g + r * 8;
      if (row < S) {
        float* orow = p.o + (((long long)b * S + row) * p.H + h) * D + 2 * t;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          store2(orow + nt * 8, o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint)
// so that the library links no libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) ==
            cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

template <int D>
int launch_prepass(const Params& p, cudaStream_t stream) {
  if (p.scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long long work = 3LL * p.B * p.H * p.S * (D / 8);
  to_bf16_kernel<D><<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using Sh = WgShape<D>;
  int rc = launch_prepass<D>(p, stream);
  if (rc != 0) return rc;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  // the scratch as (D, S, 3 * B * H): rows past S zero-fill inside each head
  CUtensorMap tmap;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)p.S, 3ull * p.B * p.H};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)p.S * D * 2};
  const cuuint32_t box[3] = {CB, WG_BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, p.scratch, dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  static_assert(Sh::SMEM <= 232448 - 1024, "shared memory of one CTA");
  auto kern = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.S + WG_BQ - 1) / WG_BQ, p.B * p.H);
  kern<<<grid, WG_THREADS, Sh::SMEM, stream>>>(tmap, p);
  return (int)cudaGetLastError();
}

// the body by head dim (see the note at the top): the bf16 prepass and the
// wgmma body at D = 128 and 256, the f32-staged body at D = 384 and 512
int dispatch(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 128: return launch_wgmma<128>(p, s);
    case 256: return launch_wgmma<256>(p, s);
    case 384: return launch<384>(p, s);
    case 512: return launch<512>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry, bound with ctypes. q, k, v and o are f32. Strides are in
// elements; the last (d) stride of q, k and v must be 1, rows 16-byte
// aligned. D is 128, 256, 384 or 512. At D = 128 and 256, scratch is a
// (3, B*H, S, D) bf16 buffer the kernel may overwrite (unused, and may be
// null, at 384 and 512). Returns the cudaError_t of the first launch that
// failed (0 on success).
extern "C" int hsi_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long qs_b, long long qs_s, long long qs_h,
    long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h,
    int B, int S, int H, int D, float scale, void* scratch, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.scratch = static_cast<__nv_bfloat16*>(scratch);
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
  p.scale = scale;
  return dispatch(p, D, static_cast<cudaStream_t>(stream));
}
