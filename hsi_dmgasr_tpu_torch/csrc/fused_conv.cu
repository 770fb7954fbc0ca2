// Fused GroupNorm -> swish -> 3x3 SAME conv for Hopper (sm_90a).
//
// Replaces the TPU kernel hsi_dmgasr_tpu/kernels/fused_conv.py:
// _gn_swish_conv3x3 / _kernel (the pl.pallas_call body, with
// _source_matmuls). It computes, per batch b, output row h, column w and
// output channel n:
//
//   out = conv3x3_SAME(swish(x * scale[b] + shift[b]), bf16(W))
//         + bias [+ time_bias[b]] [+ residual]
//
// over the channel concat [x, x2] (the second source is read in place,
// the concat is never materialised), on bf16 tensor cores with f32
// accumulation. The weights are bf16. The activation is bf16 where x is
// bf16; where x is f32 it is carried as a pair of bf16 operands, hi =
// bf16(a) and lo = bf16(a - hi) (16 bits of mantissa), and the conv is
// the two products hi x W + lo x W: only the weights are rounded, while
// x and the residual are read in f32. (Rounding x, the activation and the
// residual to bf16, as the TPU kernel does, moved a full-width f32 UNet
// forward by 1 % of its largest output over its 55 Blocks, and two
// correct implementations apart by as much.) Out-of-image taps contribute zero
// in ACTIVATED space. Optional outputs: per-row [sum, sumsq] over W of the
// f32 result (stats, (B, H, 2, Cout)), and the 1x1 projection of the RAW
// centre tap of [x, x2] (split the same way where f32) plus its bias
// (res_out). GroupNorm scale/shift per (b, c) are folded on the host from
// the moments.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at the
// 512^2 levels (C_total 64..192, Cout 64) bytes: the f32 input, output
// and residual, ~1.2-3.0 GB a launch at B=9 against 0.2-0.5 TFLOP. At
// 256^2 and below (C_total up to 1024, Cout up to 512) operations.
//
// Design: an implicit GEMM, M = output pixels, N = Cout, K = 9 * C_total,
// on mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix from 80-byte padded
// shared rows (conflict free). 8 warps, two CTAs per SM where the input
// is bf16, one where it is f32 (the lo windows take the room).
//  * Tiles, chosen on the host from Cout: 128 pixels (4 rows of 32) x 128
//    channels where Cout > 64 (every level below 512^2), 256 pixels (4
//    rows of 64) x 64 channels where Cout <= 64, and a thin 256 x 8 tile
//    for the final conv's Cout = 3. A warp owns 64 x 32 outputs (32 x 8 on
//    the thin tile). Square-ish tiles keep the 3x3 halo small: the window
//    is 1.3-1.6x the tile's pixels, against 3x for one 128-pixel row.
//  * The K loop runs in (chunk of 32 channels, tap) steps, K = 32 each,
//    through one 4-stage cp.async ring issued 3 stages ahead. A stage
//    holds the step's weight slice (BN rows x 32 of the packed
//    (J, 9, Cout, 32) weights, rows past Cout zero-filled) and a ninth of
//    the NEXT chunk's raw input window, so weights and inputs never pass
//    through registers and are always in flight. Chunk 0's window comes
//    through 9 leading stages that only stage it.
//  * The (R + 2) x (BW + 2) window is double buffered in shared memory,
//    normalised, swished and rounded to bf16 (to a hi and a lo window for
//    f32 input, whose K steps take two MMAs): each tap is a shifted view,
//    and each input element is activated once per CTA. After a step's
//    MMAs, every thread activates its units of the staged ninth into the
//    other buffer. Out-of-image positions are written as zeros after the
//    transform, by coordinate (a zero raw pixel does not activate to zero).
//  * The projection (RES) runs after the conv's outputs are stored, as a
//    second, short K loop (one K = 32 step a chunk) that reads the raw
//    centre pixels again, once and without halo, and rounds them to bf16.
//    It reuses the conv's accumulator registers, so a Block with the
//    projection keeps the same tile and two CTAs per SM; a second
//    accumulator alive through the main loop did not fit in 128 registers.
//  * Epilogue: the accumulators go through the then idle shared memory,
//    so bias, time bias and residual (loaded four pixels at a time) are
//    added in f32 and the output stored in 16-byte rows; per-row stats are
//    summed in shared memory, then one atomicAdd pair per (tile row,
//    channel).
// What held it (tools/fused_conv_ablation.py, H100, kernel alone at B=9
// 128^2 256 -> 256 in f32 before its second MMA, bound 0.176 ms): the
// MMAs alone took 0.447 ms, the ring's copies with the barrier alone
// 0.488 ms, and all of it 0.949 ms. The parts add up instead of
// overlapping, because every warp moves through copies, MMAs and
// activation together between two barriers. A
// 256-pixel tile (less weight traffic) at one CTA per SM, and producer
// warps feeding MMA warps through mbarriers at one CTA per SM, were both
// slower. Not yet done (later work): wgmma with A from registers, TMA
// (weights multicast across a cluster), a producer/consumer split that
// keeps two CTAs per SM, bf16 activations between kernels (half the
// bytes at 512^2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KC = 32;              // channels per K chunk
constexpr int KP = KC + 8;          // padded smem row: 80 bytes
constexpr int ROWB = KP * 2;        // bytes of one padded row

constexpr int NTHREADS = 256;       // 8 warps, two CTAs per SM (bf16)
constexpr int STAGES = 4;           // ring depth

// warp grid WM x WN, each warp MT m16 tiles x NT n8 tiles; tile rows of
// at most MAX_BW pixels
template <int WM_, int WN_, int MT_, int NT_, int MAX_BW_>
struct Tile {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_, MAX_BW = MAX_BW_;
  static constexpr int BM = WM * 16 * MT, BN = WN * 8 * NT;
  static_assert(WM * WN * 32 == NTHREADS, "8 warps");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments in pairs of n8 tiles");
};
using WideTile = Tile<2, 4, 4, 4, 32>;  // 128 pixels (4 x 32) x 128 channels
using TallTile = Tile<4, 2, 4, 4, 64>;  // 256 pixels (4 x 64) x 64 channels
using ThinTile = Tile<8, 1, 2, 1, 64>;  // 256 pixels (4 x 64) x 8 channels

struct Params {
  const void* x;
  const void* x2;
  const float* scale;       // (B, Ct)
  const float* shift;       // (B, Ct)
  const __nv_bfloat16* wpack;  // (J, 9, Cout, KC)
  const __nv_bfloat16* rpack;  // (J, Cout, KC) or null
  const float* bias;        // (Cout)
  const float* tb;          // (B, Cout) or null
  const void* residual;     // (B, H, W, Cout) or null
  const float* rbias;       // (Cout) or null
  void* out;                // (B, H, W, Cout)
  float* stats;             // (B, H, 2, Cout) zeroed, or null
  void* res_out;            // (B, H, W, Cout) or null
  int B, H, W, C, C2, Cout;
  int R, BW, nWseg, npix_stage, part;
};

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

__device__ __forceinline__ float swish(float a) {
  return __fdividef(a, 1.0f + __expf(-a));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// Start the copy of ROWS packed weight rows (KC bf16 each) into padded
// shared rows; rows at or past nvalid are zero-filled.
template <int ROWS>
__device__ __forceinline__ void copy_rows(uint32_t dst, const __nv_bfloat16* src, int nvalid) {
  for (int u = threadIdx.x; u < ROWS * (KC / 8); u += NTHREADS) {
    const int n = u >> 2, kq = (u & 3) * 8;
    const bool valid = n < nvalid;
    cp_async16(dst + n * ROWB + kq * 2, valid ? src + n * KC + kq : src, valid);
  }
}

// One K = 32 step of a warp tile: A rows at a_base + a_off[mt] (elements),
// B rows at b_base + b_off[]; acc[mt][nt] += A x B^T. With SPLIT, A is
// the pair of windows at a_base and a_base + lo_bytes: acc += (hi + lo) x B^T.
template <int MT, int NT, bool SPLIT>
__device__ __forceinline__ void warp_step(float (&acc)[MT][NT][4], uint32_t a_base,
                                          const int (&a_off)[MT], uint32_t b_base,
                                          const int (&b_off)[(NT + 1) / 2],
                                          uint32_t lo_bytes) {
  uint32_t thin[4];
  if (NT == 1) ldmatrix_x4(thin, b_base + 2u * b_off[0]);  // k 0..31 of 8 rows
#pragma unroll
  for (int ks = 0; ks < KC; ks += 16) {
    uint32_t b[NT][2];
    if (NT == 1) {
      b[0][0] = thin[ks / 8];
      b[0][1] = thin[ks / 8 + 1];
    } else {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, b_base + 2u * (b_off[np] + ks));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, a_base + 2u * (a_off[mt] + ks));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      if (SPLIT) {
        ldmatrix_x4(a, a_base + lo_bytes + 2u * (a_off[mt] + ks));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
}

// Activate one 16-byte unit of raw input (4 f32 or 8 bf16 channels) into
// the bf16 window: 4 f32 channels into its hi (a) and lo (a + lo) windows.
__device__ __forceinline__ void activate(const uint4& raw, bool inimg, const float* sc,
                                         const float* sh, __nv_bfloat16* a, int lo, float) {
  uint2 hi = make_uint2(0u, 0u), lw = hi;
  if (inimg) {
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(sc));
    const float4 t4 = __ldg(reinterpret_cast<const float4*>(sh));
    split_bf16(swish(__uint_as_float(raw.x) * s4.x + t4.x),
               swish(__uint_as_float(raw.y) * s4.y + t4.y), hi.x, lw.x);
    split_bf16(swish(__uint_as_float(raw.z) * s4.z + t4.z),
               swish(__uint_as_float(raw.w) * s4.w + t4.w), hi.y, lw.y);
  }
  *reinterpret_cast<uint2*>(a) = hi;
  *reinterpret_cast<uint2*>(a + lo) = lw;
}

__device__ __forceinline__ void activate(const uint4& raw, bool inimg, const float* sc,
                                         const float* sh, __nv_bfloat16* a, int,
                                         __nv_bfloat16) {
  uint4 av = make_uint4(0u, 0u, 0u, 0u);
  if (inimg) {
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(sc + 2 * i));
      const float4 t4 = __ldg(reinterpret_cast<const float4*>(sh + 2 * i));
      const float2 v0 = unpack_bf16(in[i]), v1 = unpack_bf16(in[i + 1]);
      o[i] = pack_bf16(swish(v0.x * s4.x + t4.x), swish(v0.y * s4.y + t4.y));
      o[i + 1] = pack_bf16(swish(v1.x * s4.z + t4.z), swish(v1.y * s4.w + t4.w));
    }
    av = make_uint4(o[0], o[1], o[2], o[3]);
  }
  *reinterpret_cast<uint4*>(a) = av;
}

// One 16-byte unit of raw input as the projection's operand: 8 bf16
// channels as they are, 4 f32 channels split into hi (a) and lo (a + lo).
__device__ __forceinline__ void round_raw(const uint4& raw, __nv_bfloat16* a, int lo, float) {
  uint2 hi, lw;
  split_bf16(__uint_as_float(raw.x), __uint_as_float(raw.y), hi.x, lw.x);
  split_bf16(__uint_as_float(raw.z), __uint_as_float(raw.w), hi.y, lw.y);
  *reinterpret_cast<uint2*>(a) = hi;
  *reinterpret_cast<uint2*>(a + lo) = lw;
}

__device__ __forceinline__ void round_raw(const uint4& raw, __nv_bfloat16* a, int,
                                          __nv_bfloat16) {
  *reinterpret_cast<uint4*>(a) = raw;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16-byte vectors of the output type: 4 f32 or 8 bf16
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

template <typename T, class Tl, bool RES>
__global__ void __launch_bounds__(NTHREADS, 2)
gn_swish_conv3x3_kernel(const Params p) {
  constexpr int MT = Tl::MT, NT = Tl::NT, WM = Tl::WM, BM = Tl::BM, BN = Tl::BN;
  constexpr int VIN = 16 / sizeof(T);   // input channels per 16-byte unit
  constexpr int UPP = KC / VIN;         // units per window pixel
  constexpr bool SPLIT = sizeof(T) == 4;  // f32 input: hi and lo windows
  constexpr int NWIN = SPLIT ? 4 : 2;
  extern __shared__ __align__(16) unsigned char smem[];

  const int SP = p.npix_stage;
  const uint32_t smem_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t act_s = smem_s;  // 2 x SP rows, then 2 x SP lo rows if SPLIT
  const uint32_t ring_s = act_s + NWIN * SP * ROWB;        // STAGES x (BN rows, raw part)
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = blockIdx.x * BN;
  const int hseg = blockIdx.y / p.nWseg;
  const int wseg = blockIdx.y - hseg * p.nWseg;
  const int b = blockIdx.z;
  const int R = p.R, BW = p.BW;
  const int h0 = hseg * R, w0 = wseg * BW;
  const int H = p.H, W = p.W, Cout = p.Cout;
  const int SW = BW + 2;
  const int m_valid = R * BW;
  const int Ct = p.C + p.C2;
  const int J1 = p.C / KC;
  const int J = Ct / KC;
  const int n_units = SP * UPP;

  // per-lane ldmatrix offsets (elements): A rows of the window at tap
  // (0, 0) and of the tile's own pixels; B rows of this warp's n8 tiles
  int a_off[MT], r_off[MT], b_off[(NT + 1) / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int m = wm * 16 * MT + mt * 16 + (lane & 15);
    if (m >= m_valid) m = 0;  // dummy row, result discarded
    const int r = m / BW, c = m - r * BW;
    a_off[mt] = (r * SW + c) * KP + (lane >> 4) * 8;
    r_off[mt] = m * KP + (lane >> 4) * 8;
  }
  if (NT == 1) {
    b_off[0] = (wn * 8 + (lane & 7)) * KP + (lane >> 3) * 8;
  } else {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      const int n = wn * 8 * NT + np * 16 + (lane >> 4) * 8 + (lane & 7);
      b_off[np] = n * KP + ((lane >> 3) & 1) * 8;
    }
  }

  float acc[MT][NT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int k = 0; k < NT; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][k][e] = 0.f;
  };
  zero_acc();

  const float inv_sw = 1.0f / SW;  // exact row of pix < 2^16 below
  auto unit_pos = [&](int u, int& pix, int& q, int& hh, int& ww) {
    pix = u / UPP;
    q = (u - pix * UPP) * VIN;
    const int sr = __float2int_rz((pix + 0.5f) * inv_sw);
    hh = h0 - 1 + sr;
    ww = w0 - 1 + (pix - sr * SW);
  };
  const int part = p.part;  // 16-byte window units per ring stage
  const uint32_t stage_bytes = BN * ROWB + part * 16;
  // Ring stage st (st = 0 .. 9 * (J + 1) - 1) holds the weights of K step
  // st - 9 (chunk st / 9 - 1, tap st % 9) and part st % 9 of chunk st / 9's
  // raw window.
  auto load_stage = [&](int st) {
    const int c1 = st / 9, t = st - c1 * 9;
    const uint32_t slot = ring_s + (st % STAGES) * stage_bytes;
    if (st >= 9) {
      const int s = st - 9;
      copy_rows<BN>(slot, p.wpack + ((size_t)s * Cout + n0) * KC, Cout - n0);
    }
    if (c1 < J) {
      const T* src = static_cast<const T*>(c1 < J1 ? p.x : p.x2);
      const int Cs = c1 < J1 ? p.C : p.C2;
      const int cs = (c1 < J1 ? c1 : c1 - J1) * KC;
      for (int i = tid; i < part; i += NTHREADS) {
        const int u = t * part + i;
        if (u >= n_units) break;
        int pix, q, hh, ww;
        unit_pos(u, pix, q, hh, ww);
        const bool inimg = hh >= 0 && hh < H && ww >= 0 && ww < W;
        const T* g = inimg ? src + ((size_t)(b * H + hh) * W + ww) * Cs + cs + q : src;
        cp_async16(slot + BN * ROWB + i * 16, g, inimg);
      }
    }
  };
  // activate part st % 9 of chunk st / 9 from ring stage st into its window
  auto transform = [&](int st) {
    const int c1 = st / 9, t = st - c1 * 9;
    const uint4* raw = reinterpret_cast<const uint4*>(
        smem + (ring_s - smem_s) + (st % STAGES) * stage_bytes + BN * ROWB);
    const float* sc = p.scale + (size_t)b * Ct + c1 * KC;
    const float* sh = p.shift + (size_t)b * Ct + c1 * KC;
    __nv_bfloat16* abuf = act + (c1 & 1) * SP * KP;
    for (int i = tid; i < part; i += NTHREADS) {
      const int u = t * part + i;
      if (u >= n_units) break;
      int pix, q, hh, ww;
      unit_pos(u, pix, q, hh, ww);
      const bool inimg = hh >= 0 && hh < H && ww >= 0 && ww < W;
      activate(raw[i], inimg, sc + q, sh + q, abuf + pix * KP + q, 2 * SP * KP, T());
    }
  };

  // ---- the pipeline: 9 stages that only stage chunk 0's window, then
  // the (chunk, tap) K steps, each staging a ninth of the next window
  const int TT = 9 * (J + 1);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < TT) load_stage(st);
    cp_async_commit();
  }
#pragma unroll 1
  for (int st = 0; st < TT; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    if (st + STAGES - 1 < TT) load_stage(st + STAGES - 1);
    cp_async_commit();
    const int c1 = st / 9, tap = st - c1 * 9;
    if (c1 > 0) {
      const int j = c1 - 1, dy = tap / 3, dx = tap - dy * 3;
      warp_step<MT, NT, SPLIT>(acc, act_s + (j & 1) * SP * ROWB + (dy * SW + dx) * ROWB,
                               a_off, ring_s + (st % STAGES) * stage_bytes, b_off,
                               2 * SP * ROWB);
    }
    if (c1 < J) transform(st);
  }

  // ---- epilogue, through shared memory
  constexpr int TP = BN + 4;            // padded f32 tile row
  constexpr int VO = 16 / sizeof(T);    // output channels per 16-byte vector
  constexpr int UPR = (BN + VO - 1) / VO;
  static_assert(NTHREADS % UPR == 0, "a thread keeps its channels");
  cp_async_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
  float* sst = tile + BM * TP;          // R x [sum, sumsq] x BN
  const int g = lane >> 2, t = lane & 3;
  const bool vec = Cout % VO == 0;
  T* out = static_cast<T*>(p.out);
  const T* residual = static_cast<const T*>(p.residual);

  auto acc_to_tile = [&](const float (&a)[MT][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm * 16 * MT + mt * 16 + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = wn * 8 * NT + nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(tile + m * TP + n) =
              make_float2(a[mt][nt][2 * h], a[mt][nt][2 * h + 1]);
        }
      }
  };

  if (p.stats)
    for (int i = tid; i < R * 2 * BN; i += NTHREADS) sst[i] = 0.f;
  acc_to_tile(acc);
  __syncthreads();

  // each thread keeps one VO-channel slice of the tile and walks its pixels
  {
    const int u = tid % UPR, nl = u * VO, n = n0 + nl;
    float ls[VO], lq[VO];
#pragma unroll
    for (int k = 0; k < VO; ++k) ls[k] = lq[k] = 0.f;
    int cur_r = -1;
    auto flush = [&]() {
      if (cur_r < 0) return;
#pragma unroll
      for (int k = 0; k < VO; ++k) {
        if (nl + k < BN && n + k < Cout) {
          atomicAdd(sst + (cur_r * 2) * BN + nl + k, ls[k]);
          atomicAdd(sst + (cur_r * 2 + 1) * BN + nl + k, lq[k]);
        }
        ls[k] = lq[k] = 0.f;
      }
    };
    const bool full = vec && n + VO <= Cout && nl + VO <= BN;
    float bk[VO], tk[VO];
#pragma unroll
    for (int k = 0; k < VO; ++k) {
      const bool ok = nl + k < BN && n + k < Cout;
      bk[k] = ok ? p.bias[n + k] : 0.f;
      tk[k] = ok && p.tb ? p.tb[(size_t)b * Cout + n + k] : 0.f;
    }
    // EB pixels at a time, their residual loads in flight together
    constexpr int EB = 4;
    const int pstep = NTHREADS / UPR;
    for (int mb = tid / UPR; mb < m_valid; mb += EB * pstep) {
      size_t off[EB];
      int row[EB];
      bool ok[EB];
      float rv[EB][VO];
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        const int m = mb + e * pstep;
        row[e] = m / BW;
        const int hh = h0 + row[e], ww = w0 + m - row[e] * BW;
        ok[e] = m < m_valid && hh < H && ww < W && n < Cout;
        off[e] = ok[e] ? ((size_t)(b * H + hh) * W + ww) * Cout + n : 0;
#pragma unroll
        for (int k = 0; k < VO; ++k) rv[e][k] = 0.f;
        if (residual && ok[e]) {
          if (full) {
            load_vec(residual + off[e], rv[e]);
          } else {
#pragma unroll
            for (int k = 0; k < VO; ++k)
              if (nl + k < BN && n + k < Cout) rv[e][k] = to_f(residual[off[e] + k]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < EB; ++e) {
        if (!ok[e]) continue;
        const int m = mb + e * pstep;
        float v[VO];
#pragma unroll
        for (int k = 0; k < VO; ++k) {
          v[k] = tile[m * TP + nl + (nl + k < BN ? k : 0)] + bk[k];
          if (p.tb) v[k] += tk[k];
          if (residual) v[k] += rv[e][k];
        }
        if (full) {
          store_vec(out + off[e], v);
        } else {
#pragma unroll
          for (int k = 0; k < VO; ++k)
            if (nl + k < BN && n + k < Cout) store1(out + off[e] + k, v[k]);
        }
        if (p.stats) {
          if (row[e] != cur_r) {
            flush();
            cur_r = row[e];
          }
#pragma unroll
          for (int k = 0; k < VO; ++k) {
            ls[k] += v[k];
            lq[k] += v[k] * v[k];
          }
        }
      }
    }
    if (p.stats) flush();
  }

  if (p.stats) {
    __syncthreads();
    for (int i = tid; i < R * BN; i += NTHREADS) {
      const int r = i / BN, nl = i - r * BN;
      const int hh = h0 + r, n = n0 + nl;
      if (hh >= H || n >= Cout) continue;
      float* st = p.stats + ((size_t)(b * H + hh) * 2) * Cout + n;
      atomicAdd(st, sst[(r * 2) * BN + nl]);
      atomicAdd(st + Cout, sst[(r * 2 + 1) * BN + nl]);
    }
  }

  if constexpr (RES) {
    // ---- the folded 1x1 projection: a second, short K loop over the
    // chunks' raw centre pixels, read again from memory (once, no halo),
    // so its accumulators are the conv's, now free. Two stages, each the
    // chunk's projection weights and its raw pixels, then made bf16
    // operands (a hi and a lo one where f32).
    constexpr int CU = BM * UPP;                        // raw units per chunk
    constexpr uint32_t PSTAGE = BN * ROWB + CU * 16;
    const uint32_t pa_s = smem_s + 2 * PSTAGE;          // bf16 operand, BM (+ BM lo) rows
    __nv_bfloat16* pa = reinterpret_cast<__nv_bfloat16*>(smem + 2 * PSTAGE);
    auto load_proj = [&](int j) {
      const uint32_t slot = smem_s + (j & 1) * PSTAGE;
      copy_rows<BN>(slot, p.rpack + ((size_t)j * Cout + n0) * KC, Cout - n0);
      const T* src = static_cast<const T*>(j < J1 ? p.x : p.x2);
      const int Cs = j < J1 ? p.C : p.C2;
      const int cs = (j < J1 ? j : j - J1) * KC;
      for (int u = tid; u < CU; u += NTHREADS) {
        const int m = u / UPP, q = (u - m * UPP) * VIN;
        const int r = m / BW, hh = h0 + r, ww = w0 + m - r * BW;
        const bool ok = m < m_valid && hh < H && ww < W;
        const T* g = ok ? src + ((size_t)(b * H + hh) * W + ww) * Cs + cs + q : src;
        cp_async16(slot + BN * ROWB + u * 16, g, ok);
      }
    };
    zero_acc();
    __syncthreads();  // the tile's last reads are done: its memory is reused
    load_proj(0);
    cp_async_commit();
#pragma unroll 1
    for (int j = 0; j < J; ++j) {
      cp_async_wait<0>();
      __syncthreads();  // chunk j landed; every warp is done with chunk j - 1
      if (j + 1 < J) load_proj(j + 1);
      cp_async_commit();
      const uint4* raw = reinterpret_cast<const uint4*>(smem + (j & 1) * PSTAGE + BN * ROWB);
      for (int u = tid; u < CU; u += NTHREADS) {
        const int m = u / UPP;
        round_raw(raw[u], pa + m * KP + (u - m * UPP) * VIN, BM * KP, T());
      }
      __syncthreads();
      warp_step<MT, NT, SPLIT>(acc, pa_s, r_off, smem_s + (j & 1) * PSTAGE, b_off, BM * ROWB);
    }
    __syncthreads();
    acc_to_tile(acc);
    __syncthreads();
    T* res_out = static_cast<T*>(p.res_out);
    const int u = tid % UPR, nl = u * VO, n = n0 + nl;
    for (int m = tid / UPR; m < m_valid; m += NTHREADS / UPR) {
      const int r = m / BW, c = m - r * BW;
      const int hh = h0 + r, ww = w0 + c;
      if (hh >= H || ww >= W || n >= Cout) continue;
      const size_t off = ((size_t)(b * H + hh) * W + ww) * Cout + n;
      float v[VO];
#pragma unroll
      for (int k = 0; k < VO; ++k) {
        const bool ok = nl + k < BN && n + k < Cout;
        v[k] = ok ? tile[m * TP + nl + k] + (p.rbias ? p.rbias[n + k] : 0.f) : 0.f;
      }
      if (vec && n + VO <= Cout && nl + VO <= BN) {
        store_vec(res_out + off, v);
      } else {
#pragma unroll
        for (int k = 0; k < VO; ++k)
          if (nl + k < BN && n + k < Cout) store1(res_out + off + k, v[k]);
      }
    }
  }
}

template <typename T, class Tl, bool RES>
int launch(Params p, cudaStream_t stream) {
  constexpr int BM = Tl::BM, BN = Tl::BN;
  constexpr int UPP = KC / (16 / (int)sizeof(T));
  constexpr int NWIN = sizeof(T) == 4 ? 4 : 2;  // windows: hi (and lo) x 2
  p.BW = p.W >= Tl::MAX_BW ? Tl::MAX_BW : (p.W + 15) / 16 * 16;
  p.R = BM / p.BW;
  p.nWseg = (p.W + p.BW - 1) / p.BW;
  p.npix_stage = (p.R + 2) * (p.BW + 2);
  p.part = ((p.npix_stage * UPP + 8) / 9 + 31) / 32 * 32;
  const int nH = (p.H + p.R - 1) / p.R;
  if (nH * p.nWseg > 65535 || p.B > 65535) return (int)cudaErrorInvalidValue;

  size_t main_bytes = (size_t)(NWIN * p.npix_stage + STAGES * BN) * ROWB + STAGES * p.part * 16;
  const size_t epi_bytes = (size_t)(BM * (BN + 4) + p.R * 2 * BN) * 4;
  size_t smem = main_bytes > epi_bytes ? main_bytes : epi_bytes;
  const size_t proj_bytes = (size_t)2 * (BN * ROWB + BM * UPP * 16) + NWIN / 2 * BM * ROWB;
  if (RES && proj_bytes > smem) smem = proj_bytes;
  if (smem > 232448) return (int)cudaErrorInvalidValue;

  auto kern = gn_swish_conv3x3_kernel<T, Tl, RES>;
  static size_t smem_set = 0;  // the largest dynamic size allowed so far
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid((p.Cout + BN - 1) / BN, nH * p.nWseg, p.B);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool RES>
int dispatch(const Params& p, cudaStream_t s) {
  if (p.Cout <= ThinTile::BN) return launch<T, ThinTile, RES>(p, s);
  if (p.Cout <= TallTile::BN) return launch<T, TallTile, RES>(p, s);
  return launch<T, WideTile, RES>(p, s);
}

}  // namespace

// Plain C entry, bound with ctypes. Pointers may be null for absent
// inputs (x2, rpack, tb, residual, rbias, stats, res_out). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int hsi_gn_swish_conv3x3(
    const void* x, const void* x2, const float* scale, const float* shift,
    const void* wpack, const void* rpack, const float* bias, const float* tb,
    const void* residual, const float* rbias, void* out, float* stats,
    void* res_out, int B, int H, int W, int C, int C2, int Cout,
    int is_bf16, void* stream) {
  Params p;
  p.x = x;
  p.x2 = x2;
  p.scale = scale;
  p.shift = shift;
  p.wpack = static_cast<const __nv_bfloat16*>(wpack);
  p.rpack = static_cast<const __nv_bfloat16*>(rpack);
  p.bias = bias;
  p.tb = tb;
  p.residual = residual;
  p.rbias = rbias;
  p.out = out;
  p.stats = stats;
  p.res_out = res_out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.C2 = C2;
  p.Cout = Cout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool res = rpack != nullptr;
  if (is_bf16) {
    return res ? dispatch<__nv_bfloat16, true>(p, s) : dispatch<__nv_bfloat16, false>(p, s);
  }
  return res ? dispatch<float, true>(p, s) : dispatch<float, false>(p, s);
}
