// Nearest-x2 upsample + 3x3 SAME conv + bias for Hopper (sm_90a), f32 NHWC:
// the UNet's up path (models/unet.py:Upsample, ops/fused_up.py:up2_conv3x3).
//
// Replaces no TPU kernel: the JAX package leaves this op to XLA
// (hsi_dmgasr_tpu/ops/fused_up.py:up2_conv3x3, one lhs-dilated conv). On
// the card the port's first route was cuDNN's f32 transposed convolution
// with the composed 4x4 kernel, on no tensor core (its dgrad_engine), with
// the layout permuted to NCHW and back around it.
//
// It computes out (B, 2H, 2W, Cout) from x (B, H, W, C):
//
//   out[b, 2i + a, 2j + c, n] = bias[n]
//       + sum_{dy, dx in {0, 1}} x[b, i + a - 1 + dy, j + c - 1 + dx, :] . Wp[a, c, dy, dx][:, n]
//
// with zeros outside the image: each output parity (a, c) is a 2x2
// convolution of the low-resolution input, whose taps are sums of the 3x3
// kernel's (per axis, parity 0 reads rows (i - 1, i) with (K0, K1 + K2),
// parity 1 rows (i, i + 1) with (K0 + K1, K2)), composed in f32 on the host.
// No rounding is stated for this op: x and the composed taps are f32, each
// carried as a bf16 pair hi = bf16(v), lo = bf16(v - hi), and the conv is
// x_hi W_hi + x_lo W_hi + x_hi W_lo on bf16 tensor cores with f32
// accumulation (the dropped x_lo W_lo and the residues past hi + lo are
// each below 2^-17 of |x| |W|; adding x_lo W_lo cost 21 % and came no
// closer to f64).
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s): operations,
// 2 B (2H)(2W) 4 C Cout counted once; at the UNet's four levels (B = 9,
// 32^2 .. 256^2 in, C = Cout = 512, 512, 256, 128) 77-309 GFLOP a launch
// against 0.2-0.9 GB of f32 input and output.
//
// Design: the fused Block's wgmma implicit GEMM (fused_conv.cu), one
// output parity a CTA: M = low-resolution pixels, N = Cout, K = 4 taps x C.
//  * Grid: x = parity + 4 x (Cout tile), so the four parities and the
//    Cout tiles of one pixel tile run side by side and read its window
//    from L2; y = pixel tiles; z = batch. A tile: 128 pixels (4 rows of 32)
//    x 128 channels, 8 warps, two warpgroups of 64 pixel rows x 128
//    channels (m64n128); two CTAs per SM (a 4-stage ring, one CTA per SM,
//    was 34 % slower; a 64-channel tile 52 %).
//  * The K loop runs in (chunk of 32 channels, tap) steps through a
//    3-stage cp.async ring issued 2 stages ahead. A stage holds the step's
//    weight slices, hi and lo (K-major 64-byte rows, swizzled as
//    sw64_desc reads them; rows past Cout zero-filled), and a quarter of
//    the NEXT chunk's raw (R + 1) x (BW + 1) window, zero-filled outside
//    the image by the copy itself. Chunk 0's window comes through 4
//    leading stages that only stage it.
//  * The window is split into hi and lo bf16 windows, double buffered in
//    shared memory; each tap is a shifted view of them. A comes from
//    registers: each warp ldmatrix-loads its 16 rows of the tap's view,
//    hi and lo, once per step; B from shared memory through the
//    descriptor. A step: barrier; A; wgmma.fence; 2 k16 slices x 3
//    products; commit; the refill of the ring and the split of the
//    staged quarter while the group runs; wait_group 0.
//  * Epilogue: the accumulators through the then idle shared memory, the
//    bias added in f32, 16-byte stores to the parity's output pixels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_stage.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TAPS = 4;             // a parity's 2x2 taps
constexpr int UPP = KC * 4 / 16;    // 16-byte units of f32 input a window pixel and chunk: 8
// the tile: two warpgroups of 64 pixels x BN channels, rows of at most MAX_BW
constexpr int BM = 128, BN = 128, MAX_BW = 32;
constexpr int STAGES = 3;           // ring depth
constexpr int AHEAD = STAGES - 1;   // stages the ring's loads run ahead

struct Params {
  const float* x;              // (B, H, W, C)
  const __nv_bfloat16* wpack;  // (4 parities, C / KC, 4 taps, 2 (hi, lo), Cout, KC)
  const float* bias;           // (Cout) or null
  float* out;                  // (B, 2H, 2W, Cout)
  int B, H, W, C, Cout;
  int R, BW, nWseg, npix_stage, part;
};

// 4 f32 channels of raw input into the hi (a) and lo (a + lo) windows
__device__ __forceinline__ void split_raw(const uint4& raw, __nv_bfloat16* a, int lo) {
  uint2 hi, lw;
  split_bf16(__uint_as_float(raw.x), __uint_as_float(raw.y), hi.x, lw.x);
  split_bf16(__uint_as_float(raw.z), __uint_as_float(raw.w), hi.y, lw.y);
  *reinterpret_cast<uint2*>(a) = hi;
  *reinterpret_cast<uint2*>(a + lo) = lw;
}

__global__ void __launch_bounds__(NTHREADS, 2)
up2_conv3x3_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];

  // the swizzle is laid on absolute addresses: the ring starts on its pattern
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t smem_s = (raw_s + SWZ - 1) & ~(uint32_t)(SWZ - 1);
  unsigned char* smem = smem_raw + (smem_s - raw_s);

  const int SP = p.npix_stage;
  const int part = p.part;  // 16-byte window units per ring stage, 32 | part
  constexpr uint32_t WBYTES = BN * ROWB;  // one weight slice, hi or lo
  const uint32_t stage_bytes = 2 * WBYTES + part * 16;  // a multiple of 512
  const uint32_t ring_s = smem_s;  // STAGES x (hi slice, lo slice, raw part)
  // 2 x SP hi rows, then 2 x SP lo rows
  const uint32_t act_s = ring_s + STAGES * stage_bytes;
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * stage_bytes);
  const uint32_t lo_bytes = 2 * SP * ROWB;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int par = blockIdx.x & 3, pa = par >> 1, pc = par & 1;
  const int n0 = (blockIdx.x >> 2) * BN;
  const int hseg = blockIdx.y / p.nWseg;
  const int wseg = blockIdx.y - hseg * p.nWseg;
  const int b = blockIdx.z;
  const int R = p.R, BW = p.BW;
  const int h0 = hseg * R, w0 = wseg * BW;
  const int H = p.H, W = p.W, C = p.C, Cout = p.Cout;
  const int SW = BW + 1;
  const int m_valid = R * BW;
  const int J = C / KC;
  const int n_units = SP * UPP;
  // the window's first row and column in x: tap (0, 0) of parity (pa, pc)
  const int wh0 = h0 + pa - 1, ww0 = w0 + pc - 1;

  // this warp's 16 tile rows; this lane's ldmatrix row of A, the window
  // pixel of tile row m at tap (0, 0), and its chunk half lane >> 4
  const int frow = (warp >> 2) * 64 + (warp & 3) * 16;
  int a_row;
  {
    int m = frow + (lane & 15);
    if (m >= m_valid) m = 0;  // dummy row, result discarded
    const int r = m / BW;
    a_row = r * SW + (m - r * BW);
  }
  const int half = lane >> 4;

  // n8 block j: rows g and g + 8, columns 2t and 2t + 1, in acc[4j .. 4j + 3]
  float acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;

  const float inv_sw = 1.0f / SW;  // exact row of pix < 2^16 below
  auto unit_pos = [&](int u, int& pix, int& q, int& hh, int& ww) {
    pix = u / UPP;
    q = (u - pix * UPP) * 4;
    const int sr = __float2int_rz((pix + 0.5f) * inv_sw);
    hh = wh0 + sr;
    ww = ww0 + (pix - sr * SW);
  };
  // Ring stage st (st = 0 .. 4 (J + 1) - 1) holds the weights of K step
  // st - 4 (chunk st / 4 - 1, tap st % 4) and part st % 4 of chunk st / 4's
  // raw window.
  auto load_stage = [&](int st) {
    const int c1 = st / TAPS, t = st - c1 * TAPS;
    const uint32_t slot = ring_s + (st % STAGES) * stage_bytes;
    if (st >= TAPS) {
      const __nv_bfloat16* w =
          p.wpack + ((size_t)(par * J * TAPS + st - TAPS) * 2 * Cout + n0) * KC;
      copy_rows<BN>(slot, w, Cout - n0);
      copy_rows<BN>(slot + WBYTES, w + (size_t)Cout * KC, Cout - n0);
    }
    if (c1 < J) {
      for (int i = tid; i < part; i += NTHREADS) {
        const int u = t * part + i;
        if (u >= n_units) break;
        int pix, q, hh, ww;
        unit_pos(u, pix, q, hh, ww);
        const bool inimg = hh >= 0 && hh < H && ww >= 0 && ww < W;
        const float* g = inimg ? p.x + ((size_t)(b * H + hh) * W + ww) * C + c1 * KC + q : p.x;
        cp_async16(slot + 2 * WBYTES + i * 16, g, inimg);
      }
    }
  };
  // split part st % 4 of chunk st / 4 from ring stage st into its windows
  // (out-of-image units were zero-filled, and split to zeros)
  auto transform = [&](int st) {
    const int c1 = st / TAPS, t = st - c1 * TAPS;
    const uint4* raw = reinterpret_cast<const uint4*>(
        smem + (st % STAGES) * stage_bytes + 2 * WBYTES);
    __nv_bfloat16* abuf = act + (c1 & 1) * SP * KC;
    for (int i = tid; i < part; i += NTHREADS) {
      const int u = t * part + i;
      if (u >= n_units) break;
      const int pix = u / UPP;
      split_raw(raw[i], abuf + row_elem(pix, (u - pix * UPP) * 4), 2 * SP * KC);
    }
  };

  // ---- the pipeline: 4 stages that only stage chunk 0's window, then
  // the (chunk, tap) K steps, each staging a quarter of the next window
  const int TT = TAPS * (J + 1);
#pragma unroll
  for (int st = 0; st < AHEAD; ++st) {
    load_stage(st);  // TT >= 8 > AHEAD
    cp_async_commit();
  }
#pragma unroll 1
  for (int st = 0; st < TAPS; ++st) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    load_stage(st + AHEAD);
    cp_async_commit();
    transform(st);
  }

  uint32_t afr[2][2][4];  // [k16 slice][hi, lo]
#pragma unroll 1
  for (int st = TAPS; st < TT; ++st) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();  // this thread's weight copies, to the wgmma
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    const int c1 = st / TAPS, tap = st - c1 * TAPS;
    const uint32_t a_base = act_s + ((c1 - 1) & 1) * SP * ROWB;
    const int n = a_row + (tap >> 1) * SW + (tap & 1);
    const uint32_t b_hi = ring_s + (st % STAGES) * stage_bytes;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        ldmatrix_x4(afr[ks][s], a_base + s * lo_bytes + row_off(n, 2 * ks + half));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint64_t dh = sw64_desc(b_hi + ks * 32), dl = sw64_desc(b_hi + WBYTES + ks * 32);
      wgmma_m64n128k16_rs<0>(acc, afr[ks][0], dh);  // x_hi W_hi
      wgmma_m64n128k16_rs<0>(acc, afr[ks][1], dh);  // x_lo W_hi
      wgmma_m64n128k16_rs<0>(acc, afr[ks][0], dl);  // x_hi W_lo
    }
    wgmma_commit();
    if (st + AHEAD < TT) load_stage(st + AHEAD);
    cp_async_commit();
    if (c1 < J) transform(st);
    wgmma_wait<0>();
  }
  fence_regs(acc);

  // ---- epilogue, through shared memory
  constexpr int TP = BN + 4;            // padded f32 tile row
  constexpr int UPR = BN / 4;           // 16-byte units of a tile row
  cp_async_wait<0>();
  __syncthreads();
  float* tile = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = frow + g + 8 * h;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn)
      *reinterpret_cast<float2*>(tile + m * TP + 8 * jn + 2 * t) =
          make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
  }
  __syncthreads();

  // each thread keeps one 4-channel slice of the tile and walks its pixels
  const int nl = (tid % UPR) * 4, n = n0 + nl;
  if (n >= Cout) return;  // Cout % 4 == 0: a slice is all in or all out
  float4 bk = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.bias) bk = *reinterpret_cast<const float4*>(p.bias + n);
  const size_t W2 = 2 * (size_t)W;
  for (int m = tid / UPR; m < m_valid; m += NTHREADS / UPR) {
    const int r = m / BW, c = m - r * BW;
    const int hh = h0 + r, ww = w0 + c;
    if (hh >= H || ww >= W) continue;
    const float4 v = *reinterpret_cast<const float4*>(tile + m * TP + nl);
    const size_t off = (((size_t)b * 2 * H + 2 * hh + pa) * W2 + 2 * ww + pc) * Cout + n;
    *reinterpret_cast<float4*>(p.out + off) =
        make_float4(v.x + bk.x, v.y + bk.y, v.z + bk.z, v.w + bk.w);
  }
}

int launch(Params p, cudaStream_t stream) {
  p.BW = p.W >= MAX_BW ? MAX_BW : (p.W + 15) / 16 * 16;
  p.R = BM / p.BW;
  p.nWseg = (p.W + p.BW - 1) / p.BW;
  p.npix_stage = (p.R + 1) * (p.BW + 1);
  p.part = ((p.npix_stage * UPP + TAPS - 1) / TAPS + 31) / 32 * 32;
  const int nH = (p.H + p.R - 1) / p.R;
  if (nH * p.nWseg > 65535 || p.B > 65535) return (int)cudaErrorInvalidValue;

  // hi and lo windows x 2 buffers, and the ring
  const size_t main_bytes = (size_t)4 * p.npix_stage * ROWB +
                            STAGES * ((size_t)2 * BN * ROWB + p.part * 16);
  const size_t epi_bytes = (size_t)BM * (BN + 4) * 4;
  size_t smem = main_bytes > epi_bytes ? main_bytes : epi_bytes;
  smem += SWZ;  // room to start the ring on the swizzle's pattern
  if (smem > 232448) return (int)cudaErrorInvalidValue;

  static size_t smem_set = 0;  // the largest dynamic size allowed so far
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        up2_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(up2_conv3x3_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(4 * ((p.Cout + BN - 1) / BN), nH * p.nWseg, p.B);
  up2_conv3x3_kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry, bound with ctypes. x, out: contiguous f32 NHWC, 16-byte
// aligned; wpack: the packed hi and lo taps; bias may be null. C % 32 == 0,
// Cout % 4 == 0. Returns the cudaError_t of the launch (0 on success).
extern "C" int hsi_up2_conv3x3(const float* x, const void* wpack, const float* bias,
                               float* out, int B, int H, int W, int C, int Cout,
                               void* stream) {
  if (C % KC || Cout % 4 || C <= 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.wpack = static_cast<const __nv_bfloat16*>(wpack);
  p.bias = bias;
  p.out = out;
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.Cout = Cout;
  return launch(p, static_cast<cudaStream_t>(stream));
}
