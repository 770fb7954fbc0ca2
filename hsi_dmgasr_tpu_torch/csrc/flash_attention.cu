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
// (they are the strided q/k/v views of the UNet's qkv split, so no
// transpose and no pad is materialised) and rounded to bf16 as they are
// staged; out is a fresh contiguous (B, S, H, D) f32 tensor.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): operations.
// At the main path's shape (B*H = 9, S = 16384, D = 256) one launch is
// 4 * 9 * 16384^2 * 256 = 2.47 TFLOP, 2.50 ms at the bf16 peak, against
// ~0.6 GB of f32 q, k, v and out, 0.18 ms. The 2.4e9 exponentials run on
// the SFUs beside the tensor cores and are a visible share of the time.
//
// Design (FlashAttention-2 shape on mma.sync; the TPU's sequential grid and
// DMA semaphores become a loop over K/V tiles inside each CTA):
//  * grid: query tiles of BQ rows x output column slices of DV x (B*H).
//    Each warp owns 16 query rows, so the softmax row statistics stay in
//    one warp (two shuffles per reduction, no shared memory).
//  * Q is staged once per CTA as bf16(q * scale). Each 32-key K tile (all
//    D columns) and V tile (the CTA's DV columns) arrives by cp.async in
//    f32, issued one tile ahead so the copy of tile j + 1
//    overlaps the MMAs of tile j; it is then rounded to bf16 into padded
//    rows (16 bytes of padding: every ldmatrix is conflict free).
//  * S = Q K^T and O += P V run on mma.sync m16n8k16 bf16 -> f32. P goes
//    from the S accumulators to A fragments in registers (no shared
//    memory round trip); V's B fragments come from ldmatrix.trans.
//  * registers bound the width: a warp's f32 output accumulator is
//    16 x DV, 128 registers a thread at DV = 256. So DV = D up to 256
//    (no recomputation at the main path's D = 256); D = 384 and 512 take
//    two column slices that each recompute Q K^T. exp is ex2.approx on
//    log2e-scaled logits.
// Not yet done (later work): wgmma with TMA-fed K/V tiles and warp
// specialisation. Every warp re-reads the K and V tiles from shared memory
// through ldmatrix, which caps mma.sync well below the card's peak.

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

int dispatch(const Params& p, int D, cudaStream_t s) {
  switch (D) {
    case 128: return launch<128>(p, s);
    case 256: return launch<256>(p, s);
    case 384: return launch<384>(p, s);
    case 512: return launch<512>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry, bound with ctypes. q, k, v and o are f32. Strides are in
// elements; the last
// (d) stride of q, k and v must be 1, rows 16-byte aligned. D is 128, 256,
// 384 or 512. Returns the cudaError_t of the launch (0 on success).
extern "C" int hsi_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long qs_b, long long qs_s, long long qs_h,
    long long ks_b, long long ks_s, long long ks_h,
    long long vs_b, long long vs_s, long long vs_h,
    int B, int S, int H, int D, float scale, void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
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
