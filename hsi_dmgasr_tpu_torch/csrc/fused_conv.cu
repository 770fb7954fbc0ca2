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
// in ACTIVATED space. Under an H-shard (spatially sharded inference) x is a
// rank's rows, and the taps at rows -1 and H read the neighbour ranks'
// boundary rows (halo_prev / halo_next, (B, 1, W, C), and halo_prev2 /
// halo_next2 for x2), raw, unless the rank's edge flag marks a true image
// edge there: the halo rows go through the same activation as the interior
// rows (the TPU kernel takes them pre-activated and rounded to bf16 from
// the host). The scale and shift are then the whole image's. Optional
// outputs: per-row [sum, sumsq] over W of the f32 result (stats,
// (B, H, 2, Cout)), and the 1x1 projection of the RAW centre tap of
// [x, x2] (split the same way where f32) plus its bias (res_out).
// GroupNorm scale/shift per (b, c) are folded on the host from the
// moments.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 989 TFLOP/s bf16): at the
// 512^2 levels (C_total 64..192, Cout 64) bytes: the f32 input, output
// and residual, ~1.2-3.0 GB a launch at B=9 against 0.2-0.5 TFLOP. At
// 256^2 and below (C_total up to 1024, Cout up to 512) operations.
//
// Design: an implicit GEMM, M = output pixels, N = Cout, K = 9 * C_total.
//  * Tiles, chosen on the host from Cout: 128 pixels (4 rows of 32) x 128
//    channels where Cout > 64 (Wide: every level below 512^2); 64 channels
//    x 128 pixels (2 rows of 64) at f32 input, 256 (4 x 64) at bf16, where
//    8 < Cout <= 64 (Tall: the 512^2 level); and a thin 256 (4 x 64) x 8
//    tile for the final conv's Cout = 3. 8 warps, two CTAs per SM. Square-
//    ish tiles keep the 3x3 halo small.
//  * Wide and Tall run on wgmma.mma_async (bf16 x bf16 -> f32): each of the
//    two warpgroups owns 64 pixel rows (128 on the bf16 Tall tile) x the
//    CTA's whole N (m64n128, or one or two m64n64; 64 or 32 f32
//    accumulators a thread). A comes from registers:
//    each warp ldmatrix-loads its own 16 rows of the tap's view of the
//    activated window (mma.sync's A fragment is wgmma's), once per step. B,
//    the step's weight slice, is read by the wgmma from shared memory
//    through a 64-byte-swizzle descriptor (wgmma.cuh: sw64_desc): K-major
//    64-byte rows, the swizzle applied as the cp.async writes them, so B
//    never enters registers. The windows and the projection's operand use
//    the same swizzled rows: ldmatrix reads any 8 consecutive ones without
//    bank conflicts, and padded rows would take 25 % more room (and no
//    descriptor describes them). (The 128-byte swizzle would need K = 64 a
//    stage, two taps or two chunks: a ring with other steps.) The
//    thin tile keeps mma.sync m16n8k16 (a 64-row wgmma with N = 8 gains
//    nothing), each warp 32 x 8, reading the same B rows with ldmatrix.
//  * The K loop runs in (chunk of 32 channels, tap) steps, K = 32 each,
//    through one 5-stage cp.async ring issued 4 stages ahead. A stage holds
//    the step's weight slice (rows past Cout zero-filled) and a ninth of the
//    NEXT chunk's raw input window, so weights and inputs never pass
//    through registers and are always in flight. Chunk 0's window comes
//    through 9 leading stages that only stage it.
//  * The (R + 2) x (BW + 2) window is double buffered in shared memory,
//    normalised, swished and rounded to bf16 (to a hi and a lo window for
//    f32 input, whose K steps take twice the MMAs): each tap is a shifted
//    view, and each input element is activated once per CTA. Out-of-image
//    positions are written as zeros after the transform, by coordinate (a
//    zero raw pixel does not activate to zero).
//  * A wgmma K step, in one commit group: the barrier (stage st landed, each
//    thread's copies fenced to the async proxy first); ldmatrix of the
//    step's A; wgmma.fence; the step's wgmmas (f32: 2 k16 slices x hi, lo;
//    bf16: 2); commit. While they run, the cp.async of stage st + 4 and the
//    activation of the staged ninth into the other window; then
//    wgmma.wait_group 0, so the group has retired, its A registers are
//    free and its slot can be refilled, before the next barrier.
//  * The projection (RES) runs after the conv's outputs are stored, as a
//    second, short K loop (one K = 32 step a chunk, each retired before the
//    next) that reads the raw centre pixels again, once and without halo,
//    and rounds them to bf16. It reuses the conv's accumulator registers.
//  * Epilogue: the accumulators go through the then idle shared memory,
//    so bias, time bias and residual (loaded four pixels at a time) are
//    added in f32 and the output stored in 16-byte rows; per-row stats are
//    summed in shared memory, then one atomicAdd pair per (tile row,
//    channel).
// The wgmma helpers came from blocked_dot.cu and are shared with it
// (wgmma.cuh: sw128_desc, wgmma_fence, wgmma_commit, wgmma_wait, fence_regs).
// What bounds it (tools/fused_conv_ablation.py, H100, each kernel alone at
// B=9, f32): at 128^2 256 -> 256 (Wide, bound 0.35 ms by operations) the
// MMAs alone take 0.60 ms, the ring's copies with the barrier alone 0.59,
// the activation about 0.2 more, all of it 1.12 (the mma.sync kernel: 0.92,
// 0.87 and 2.00); at 512^2 64 -> 64 (Tall, bound 0.36 ms by bytes) the
// latency of the staging chain, 16 warps an SM.
// Tried and slower (the same calls): one wgmma group left in flight across
// the barrier (wait_group 1, A in two register sets, the ring 2 or 3
// stages ahead): Wide 1.22-1.27 ms against 1.10 (retired after the next
// barrier instead, with one register set: 1.12 against 1.13, no gain at
// any shape tried); a 4-stage ring: 1.14-1.20;
// one CTA per SM with 255 registers: 1.65; the Tall tile as 256 pixels at
// f32 (4 x 64, two m64 blocks a warpgroup, one CTA per SM for its windows):
// 3.00 ms against 2.40 at 512^2 64 -> 64 (at bf16, two CTAs per SM either
// way, the 128-pixel tile took 2.85 ms against the mma.sync kernel's 2.22).
// Before wgmma: a 256-pixel Wide tile at one CTA per SM, and producer warps
// feeding MMA warps through mbarriers. Not yet done (later work): TMA
// (weights multicast across a cluster), bf16 activations between kernels
// (half the bytes at 512^2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_stage.cuh"
#include "wgmma.cuh"

namespace {

constexpr int STAGES = 5;           // ring depth

// wgmma tile: two warpgroups, each MF m64 blocks x the CTA's BN (one
// m64nBNk16 wgmma a block and k16 slice); tile rows of at most MAX_BW pixels
template <int MF_, int BN_, int MAX_BW_>
struct WgTile {
  static constexpr bool WG = true;
  static constexpr int MF = MF_, BN = BN_, MAX_BW = MAX_BW_;
  static constexpr int BM = 2 * 64 * MF;
  static_assert(BN == 64 || BN == 128, "m64n64 or m64n128");
};
// mma.sync tile: 8 warps down M, each MF m16 tiles x one n8 tile
template <int MF_, int MAX_BW_>
struct SyncTile {
  static constexpr bool WG = false;
  static constexpr int MF = MF_, BN = 8, MAX_BW = MAX_BW_;
  static constexpr int BM = 8 * 16 * MF;
};
using WideTile = WgTile<1, 128, 32>;  // 128 pixels (4 x 32) x 128 channels
// 64 channels x 128 pixels (2 x 64) for f32 input, whose hi and lo windows
// leave room for two CTAs per SM only so; x 256 pixels (4 x 64) for bf16
template <typename T>
using TallTile = WgTile<sizeof(T) == 4 ? 1 : 2, 64, 64>;
using ThinTile = SyncTile<2, 64>;     // 256 pixels (4 x 64) x 8 channels

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
  const void* hp;           // (B, 1, W, C): row -1 (the previous rank's last) or null
  const void* hn;           // (B, 1, W, C): row H (the next rank's first) or null
  const void* hp2;          // (B, 1, W, C2): the same rows of x2, or null
  const void* hn2;
  int has_prev, has_next;   // rows -1 / H come from hp / hn (not a true edge)
  int B, H, W, C, C2, Cout;
  int R, BW, nWseg, npix_stage, part;
};

__device__ __forceinline__ float swish(float a) {
  return __fdividef(a, 1.0f + __expf(-a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of one K = 32 step: this warp's 16 rows of each of its MF
// blocks, this lane's row n = a_row[f] + shift of the tile at a_base (its
// chunk half + 2 ks for k16 slice ks), and with NS = 2 the lo tile at
// a_base + lo_bytes too
template <int MF, int NS>
__device__ __forceinline__ void load_a(uint32_t (&a)[MF][2][NS][4], uint32_t a_base,
                                       const int (&a_row)[MF], int shift, int half,
                                       uint32_t lo_bytes) {
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    const int n = a_row[f] + shift;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int s = 0; s < NS; ++s)
        ldmatrix_x4(a[f][ks][s], a_base + s * lo_bytes + row_off(n, 2 * ks + half));
  }
}

// Issue one K = 32 step of a warpgroup: acc[f] += A[f] x B^T, B the BN
// swizzled weight rows of the slice at b_s
template <int MF, int BN, int NS>
__device__ __forceinline__ void wg_step(float (&acc)[MF][BN / 2], const uint32_t (&a)[MF][2][NS][4],
                                        uint32_t b_s) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint64_t db = sw64_desc(b_s + ks * 32);
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if constexpr (BN == 128) wgmma_m64n128k16_rs<0>(acc[f], a[f][ks][s], db);
        else wgmma_m64n64k16_rs<0>(acc[f], a[f][ks][s], db);
      }
  }
}

// One K = 32 step of a thin-tile warp (mma.sync): A rows as load_a reads
// them, the 8 weight rows through ldmatrix at b_addr (this lane's row and
// chunk); acc[mt] += A x B^T. With SPLIT, A is the pair of tiles at a_base
// and a_base + lo_bytes: acc += (hi + lo) x B^T.
template <int MT, bool SPLIT>
__device__ __forceinline__ void warp_step(float (&acc)[MT][4], uint32_t a_base,
                                          const int (&a_row)[MT], int shift, int half,
                                          uint32_t b_addr, uint32_t lo_bytes) {
  uint32_t b[4];
  ldmatrix_x4(b, b_addr);  // k 0..31 of 8 rows
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint32_t at = a_base + row_off(a_row[mt] + shift, 2 * ks + half);
      uint32_t a[4];
      ldmatrix_x4(a, at);
      mma_bf16(acc[mt], a, b[2 * ks], b[2 * ks + 1]);
      if (SPLIT) {
        ldmatrix_x4(a, at + lo_bytes);
        mma_bf16(acc[mt], a, b[2 * ks], b[2 * ks + 1]);
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
  constexpr bool WG = Tl::WG;
  constexpr int MF = Tl::MF, BM = Tl::BM, BN = Tl::BN;
  constexpr int VIN = 16 / sizeof(T);   // input channels per 16-byte unit
  constexpr int UPP = KC / VIN;         // units per window pixel
  constexpr bool SPLIT = sizeof(T) == 4;  // f32 input: hi and lo windows
  constexpr int NS = SPLIT ? 2 : 1;
  constexpr int AHEAD = STAGES - 1;     // stages the ring's loads run ahead
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // the swizzle is laid on absolute addresses: the ring starts on its pattern
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t smem_s = (raw_s + SWZ - 1) & ~(uint32_t)(SWZ - 1);
  unsigned char* smem = smem_raw + (smem_s - raw_s);

  const int SP = p.npix_stage;
  const int part = p.part;  // 16-byte window units per ring stage, 32 | part
  const uint32_t stage_bytes = BN * ROWB + part * 16;  // a multiple of 512
  const uint32_t ring_s = smem_s;  // STAGES x (BN weight rows, raw part)
  const uint32_t act_s = ring_s + STAGES * stage_bytes;  // 2 x SP rows, then 2 x SP lo rows if SPLIT
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * stage_bytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
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

  // first tile row of this warp's fragment f: a warpgroup's m64 blocks
  // (its warp's 16 rows of each), or a thin-tile warp's m16 tiles
  auto frag_row = [&](int f) {
    return WG ? ((warp >> 2) * MF + f) * 64 + (warp & 3) * 16 : warp * 16 * MF + f * 16;
  };
  // this lane's ldmatrix rows of A: the window pixel of each fragment's
  // row at tap (0, 0), and the tile's own pixel; its chunk half lane >> 4
  int a_row[MF], r_row[MF];
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    int m = frag_row(f) + (lane & 15);
    if (m >= m_valid) m = 0;  // dummy row, result discarded
    const int r = m / BW, c = m - r * BW;
    a_row[f] = r * SW + c;
    r_row[f] = m;
  }
  const int half = lane >> 4;
  // the thin tile's B lane: weight row lane & 7, chunk lane >> 3
  const uint32_t b_lane = row_off(lane & 7, lane >> 3);

  // fragment f's n8 block j: rows g and g + 8, columns 2t and 2t + 1, in
  // acc[f][4j .. 4j + 3] (wgmma's m64 layout, and mma.sync's for one n8)
  float acc[MF][BN / 2];
  auto zero_acc = [&]() {
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[f][e] = 0.f;
  };
  auto retire = [&]() {  // every wgmma group done, its accumulators readable
    if constexpr (WG) {
      wgmma_wait<0>();
#pragma unroll
      for (int f = 0; f < MF; ++f) fence_regs(acc[f]);
    }
  };
  zero_acc();

  // window position (hh, ww) holds an input pixel: inside the image, or on
  // a halo row where the neighbour rank has one
  auto in_window = [&](int hh, int ww) {
    return ww >= 0 && ww < W &&
           ((hh >= 0 && hh < H) || (hh == -1 && p.has_prev) || (hh == H && p.has_next));
  };
  const float inv_sw = 1.0f / SW;  // exact row of pix < 2^16 below
  auto unit_pos = [&](int u, int& pix, int& q, int& hh, int& ww) {
    pix = u / UPP;
    q = (u - pix * UPP) * VIN;
    const int sr = __float2int_rz((pix + 0.5f) * inv_sw);
    hh = h0 - 1 + sr;
    ww = w0 - 1 + (pix - sr * SW);
  };
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
      const T* src_prev = static_cast<const T*>(c1 < J1 ? p.hp : p.hp2);
      const T* src_next = static_cast<const T*>(c1 < J1 ? p.hn : p.hn2);
      const int Cs = c1 < J1 ? p.C : p.C2;
      const int cs = (c1 < J1 ? c1 : c1 - J1) * KC;
      for (int i = tid; i < part; i += NTHREADS) {
        const int u = t * part + i;
        if (u >= n_units) break;
        int pix, q, hh, ww;
        unit_pos(u, pix, q, hh, ww);
        const bool inimg = in_window(hh, ww);
        const T* g = src;
        if (inimg) {
          const bool halo = hh < 0 || hh >= H;
          const size_t at = halo ? (size_t)b * W + ww : (size_t)(b * H + hh) * W + ww;
          g = (halo ? (hh < 0 ? src_prev : src_next) : src) + at * Cs + cs + q;
        }
        cp_async16(slot + BN * ROWB + i * 16, g, inimg);
      }
    }
  };
  // activate part st % 9 of chunk st / 9 from ring stage st into its window
  auto transform = [&](int st) {
    const int c1 = st / 9, t = st - c1 * 9;
    const uint4* raw = reinterpret_cast<const uint4*>(
        smem + (st % STAGES) * stage_bytes + BN * ROWB);
    const float* sc = p.scale + (size_t)b * Ct + c1 * KC;
    const float* sh = p.shift + (size_t)b * Ct + c1 * KC;
    __nv_bfloat16* abuf = act + (c1 & 1) * SP * KC;
    for (int i = tid; i < part; i += NTHREADS) {
      const int u = t * part + i;
      if (u >= n_units) break;
      int pix, q, hh, ww;
      unit_pos(u, pix, q, hh, ww);
      const bool inimg = in_window(hh, ww);
      activate(raw[i], inimg, sc + q, sh + q, abuf + row_elem(pix, q), 2 * SP * KC, T());
    }
  };

  // ---- the pipeline: 9 stages that only stage chunk 0's window, then
  // the (chunk, tap) K steps, each staging a ninth of the next window
  const int TT = 9 * (J + 1);
#pragma unroll
  for (int st = 0; st < AHEAD; ++st) {
    load_stage(st);  // TT >= 18 > AHEAD
    cp_async_commit();
  }
#pragma unroll 1
  for (int st = 0; st < 9; ++st) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    load_stage(st + AHEAD);
    cp_async_commit();
    transform(st);
  }

  // the K steps: a wgmma step issues its group, then refills the ring and
  // activates the staged ninth while the group runs, and retires the group
  // before the next barrier
  uint32_t afr[MF][2][NS][4];
#pragma unroll 1
  for (int st = 9; st < TT; ++st) {
    cp_async_wait<AHEAD - 1>();
    if constexpr (WG) fence_proxy_async();  // this thread's weight copies, to the wgmma
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    const int c1 = st / 9, tap = st - c1 * 9;
    const int j = c1 - 1, dy = tap / 3, dx = tap - dy * 3;
    const uint32_t a_base = act_s + (j & 1) * SP * ROWB;
    const int shift = dy * SW + dx;
    const uint32_t b_s = ring_s + (st % STAGES) * stage_bytes;
    if constexpr (WG) {
      load_a<MF, NS>(afr, a_base, a_row, shift, half, 2 * SP * ROWB);
      wgmma_fence();
      wg_step<MF, BN, NS>(acc, afr, b_s);
      wgmma_commit();
    }
    if (st + AHEAD < TT) load_stage(st + AHEAD);
    cp_async_commit();
    if constexpr (!WG)
      warp_step<MF, SPLIT>(acc, a_base, a_row, shift, half, b_s + b_lane, 2 * SP * ROWB);
    if (c1 < J) transform(st);
    if constexpr (WG) wgmma_wait<0>();
  }
  retire();

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

  auto acc_to_tile = [&]() {
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = frag_row(f) + g + 8 * h;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn)
          *reinterpret_cast<float2*>(tile + m * TP + 8 * jn + 2 * t) =
              make_float2(acc[f][4 * jn + 2 * h], acc[f][4 * jn + 2 * h + 1]);
      }
  };

  if (p.stats)
    for (int i = tid; i < R * 2 * BN; i += NTHREADS) sst[i] = 0.f;
  acc_to_tile();
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
    // chunk's projection weights (swizzled rows) and its raw pixels, then
    // made bf16 operands (a hi and a lo one where f32).
    constexpr int CU = BM * UPP;                        // raw units per chunk
    constexpr uint32_t PSTAGE = BN * ROWB + CU * 16;    // a multiple of 512
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
      if constexpr (WG) fence_proxy_async();
      __syncthreads();  // chunk j landed; every warp is done with chunk j - 1
      if (j + 1 < J) load_proj(j + 1);
      cp_async_commit();
      const uint32_t slot = smem_s + (j & 1) * PSTAGE;
      const uint4* raw = reinterpret_cast<const uint4*>(smem + (j & 1) * PSTAGE + BN * ROWB);
      for (int u = tid; u < CU; u += NTHREADS) {
        const int m = u / UPP;
        round_raw(raw[u], pa + row_elem(m, (u - m * UPP) * VIN), BM * KC, T());
      }
      __syncthreads();
      if constexpr (WG) {
        load_a<MF, NS>(afr, pa_s, r_row, 0, half, BM * ROWB);
        wgmma_fence();
        wg_step<MF, BN, NS>(acc, afr, slot);
        wgmma_commit();
        wgmma_wait<0>();
      } else {
        warp_step<MF, SPLIT>(acc, pa_s, r_row, 0, half, slot + b_lane, BM * ROWB);
      }
    }
    retire();
    __syncthreads();
    acc_to_tile();
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

  size_t main_bytes = (size_t)NWIN * p.npix_stage * ROWB + STAGES * ((size_t)BN * ROWB + p.part * 16);
  const size_t epi_bytes = (size_t)(BM * (BN + 4) + p.R * 2 * BN) * 4;
  size_t smem = main_bytes > epi_bytes ? main_bytes : epi_bytes;
  const size_t proj_bytes = (size_t)2 * (BN * ROWB + BM * UPP * 16) + NWIN / 2 * BM * ROWB;
  if (RES && proj_bytes > smem) smem = proj_bytes;
  smem += SWZ;  // room to start the ring on the swizzle's pattern
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

// the route by Cout: the thin mma.sync tile, else a wgmma tile
template <typename T, bool RES>
int dispatch(const Params& p, cudaStream_t s) {
  if (p.Cout <= ThinTile::BN) return launch<T, ThinTile, RES>(p, s);
  if (p.Cout <= TallTile<T>::BN) return launch<T, TallTile<T>, RES>(p, s);
  return launch<T, WideTile, RES>(p, s);
}

}  // namespace

// Plain C entry, bound with ctypes. Pointers may be null for absent
// inputs (x2, rpack, tb, residual, rbias, stats, res_out, the halo rows:
// without them rows -1 and H are out of the image). is_first / is_last mark
// a true image edge above / below this shard, where the halo row is not
// read. Returns the cudaError_t of the launch (0 on success).
extern "C" int hsi_gn_swish_conv3x3(
    const void* x, const void* x2, const float* scale, const float* shift,
    const void* wpack, const void* rpack, const float* bias, const float* tb,
    const void* residual, const float* rbias, void* out, float* stats,
    void* res_out, int B, int H, int W, int C, int C2, int Cout,
    int is_bf16, const void* halo_prev, const void* halo_next,
    const void* halo_prev2, const void* halo_next2, int is_first, int is_last,
    void* stream) {
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
  p.hp = halo_prev;
  p.hn = halo_next;
  p.hp2 = halo_prev2;
  p.hn2 = halo_next2;
  p.has_prev = halo_prev != nullptr && !is_first;
  p.has_next = halo_next != nullptr && !is_last;
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
