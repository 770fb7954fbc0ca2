"""Analytic roofline of one fused SR3 UNet sampler step, on the card.

A copy of the arithmetic of ``hsi_dmgasr_tpu/utils/roofline.py``: it
walks the op sequence of the UNet's fused forward (reference
sr3_modules/unet.py:162-263) and counts, per op,

  * ``flops``: matmul and conv multiply-adds x2 (normalisation and
    activation work is left out: it is orders of magnitude below the conv
    FLOPs at every level), and
  * ``bytes``: the least device-memory traffic under the fused kernel
    boundaries, every activation crossing a kernel boundary counted once
    in bf16, weights once.

The op list is the JAX module's for the same arguments. Only the peaks
differ: they are the card's, looked up by ``torch.cuda.get_device_name()``,
and a device that is not in the table raises (there is no fallback peak).
"""

from __future__ import annotations

from dataclasses import dataclass

# (dense bf16 TFLOP/s, device-memory GB/s) by device-name prefix. H100 SXM:
# 989 TFLOP/s and 3.35 TB/s HBM3 (NVIDIA data sheet), at a 700 W limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}


# dense f32 TFLOP/s outside the tensor cores (what an f32 run with TF32
# off gets from cuDNN and cuBLAS), by device-name prefix. H100 SXM: 67
# TFLOP/s (NVIDIA data sheet), at a 700 W limit.
DEVICE_F32_PEAKS = {
    "NVIDIA H100 80GB HBM3": 67.0,
}


def device_f32_peak(device_kind: str):
    """f32 TFLOP/s (no tensor cores) of the named device; raises for an
    unknown one."""
    for k, v in DEVICE_F32_PEAKS.items():
        if device_kind.lower().startswith(k.lower()):
            return v
    raise ValueError(f"no f32 peak for device {device_kind!r}; known: "
                     f"{sorted(DEVICE_F32_PEAKS)}")


def device_peaks(device_kind: str):
    """(bf16 TFLOP/s, GB/s) of the named device; raises for an unknown one."""
    for k, v in DEVICE_PEAKS.items():
        if device_kind.lower().startswith(k.lower()):
            return v
    raise ValueError(f"no roofline peaks for device {device_kind!r}; known: "
                     f"{sorted(DEVICE_PEAKS)}")


@dataclass
class Op:
    name: str
    flops: float
    bytes: float


def _conv(B, res_in, cin, cout, stride=1, k=3):
    out_px = B * (res_in // stride) ** 2
    return (2.0 * out_px * k * k * cin * cout,
            2.0 * (B * res_in * res_in * cin + out_px * cout)
            + 2.0 * k * k * cin * cout)


def _resblock(B, res, cin, c2, cout):
    """Fused resblock: block1 = GN+swish+conv3x3 [cin+c2 -> cout] with the
    1x1 res projection in the same pass when channels change; block2 =
    GN+swish+conv3x3 [cout -> cout] + residual. block1 reads [x, x2] once
    and writes h (+ the projection); block2 reads h (+ residual) and
    writes out; chained moments keep the GroupNorm reads out."""
    ct = cin + c2
    px = B * res * res
    proj = ct != cout
    flops = (2.0 * px * 9 * ct * cout
             + (2.0 * px * ct * cout if proj else 0.0)
             + 2.0 * px * 9 * cout * cout)
    b1 = 2.0 * (px * ct + px * cout + (px * cout if proj else 0.0))
    b2 = 2.0 * (px * cout + (px * cout if proj else px * ct) + px * cout)
    wts = 2.0 * (9 * ct * cout + 9 * cout * cout + (ct * cout if proj else 0))
    return flops, b1 + b2 + wts


def _up2conv(B, res, c):
    """nearest-x2 + conv3x3 as one conv with the composed 4x4 kernel
    (ops/fused_up.py): each output pixel reads a 2x2 input window."""
    out_px = B * (2 * res) ** 2
    return (2.0 * out_px * 4 * c * c,
            2.0 * (B * res * res * c + out_px * c) + 2.0 * 16 * c * c)


def _attention(B, res, c):
    px = B * res * res
    n = res * res
    flops = (3 * 2.0 * px * c * c          # qkv 1x1
             + 2 * 2.0 * B * n * n * c     # scores + weighted sum
             + 2.0 * px * c * c)           # out 1x1
    return flops, 2.0 * 6 * px * c + 2.0 * 4 * c * c


def unet_step_ops(B, size, inner=64, mults=(1, 2, 4, 8, 8), res_blocks=2,
                  attn_res=(16,), in_channel=6, out_channel=3):
    """Op list (name, flops, least bytes) of ONE fused UNet forward at
    (B, size, size, in_channel)."""
    ops = []

    def add(name, fb):
        ops.append(Op(name, *fb))

    now = size
    add(f"downs_0[{now}^2 {in_channel}->{inner}]",
        _conv(B, now, in_channel, inner))
    feats = [inner]
    ch_in = inner
    for ind, m in enumerate(mults):
        ch = inner * m
        for _ in range(res_blocks):
            add(f"rb[{now}^2 {ch_in}->{ch}]", _resblock(B, now, ch_in, 0, ch))
            if now in attn_res:
                add(f"attn[{now}^2x{ch}]", _attention(B, now, ch))
            feats.append(ch)
            ch_in = ch
        if ind != len(mults) - 1:
            add(f"ds[{now}^2 {ch}]", _conv(B, now, ch, ch, stride=2))
            feats.append(ch)
            now //= 2

    add(f"mid_attn_rb[{now}^2x{ch_in}]", _resblock(B, now, ch_in, 0, ch_in))
    add(f"mid_attn[{now}^2x{ch_in}]", _attention(B, now, ch_in))
    add(f"mid_rb[{now}^2x{ch_in}]", _resblock(B, now, ch_in, 0, ch_in))

    for ind in reversed(range(len(mults))):
        ch = inner * mults[ind]
        for _ in range(res_blocks + 1):
            c2 = feats.pop()
            add(f"rb_up[{now}^2 {ch_in}+{c2}->{ch}]",
                _resblock(B, now, ch_in, c2, ch))
            if now in attn_res:
                add(f"attn[{now}^2x{ch}]", _attention(B, now, ch))
            ch_in = ch
        if ind >= 1:
            add(f"up2conv[{now}^2x{ch}]", _up2conv(B, now, ch))
            now *= 2

    add(f"final[{now}^2 {ch_in}->{out_channel}]",
        _conv(B, now, ch_in, out_channel))
    # the sampler's posterior math: ~6 f32 elementwise passes over the state
    st = B * size * size * out_channel * 4.0
    ops.append(Op("posterior_math", 0.0, 12.0 * st))
    return ops


def step_roofline(B, size, device_kind, **kw):
    """Roofline table of one denoise step on ``device_kind``: per op and
    in total."""
    tflops, gbps = device_peaks(device_kind)
    ops = unet_step_ops(B, size, **kw)
    rows = []
    for op in ops:
        mxu_s = op.flops / (tflops * 1e12)
        hbm_s = op.bytes / (gbps * 1e9)
        rows.append({
            "op": op.name, "gflop": op.flops / 1e9, "mb": op.bytes / 1e6,
            "mxu_ms": mxu_s * 1e3, "hbm_ms": hbm_s * 1e3,
            "bound": "mxu" if mxu_s > hbm_s else "hbm",
            "attainable_ms": max(mxu_s, hbm_s) * 1e3,
        })
    tot_f = sum(o.flops for o in ops)
    tot_b = sum(o.bytes for o in ops)
    return {
        "device_kind": device_kind,
        "peak_tflops": tflops, "peak_gbps": gbps,
        "ops": rows,
        "total_gflop": tot_f / 1e9,
        "total_gb": tot_b / 1e9,
        "mxu_s": tot_f / (tflops * 1e12),
        "hbm_s": tot_b / (gbps * 1e9),
        # every op at its own roofline: tighter than max(total mxu, total
        # hbm) when ops alternate between the two bounds
        "attainable_s": sum(r["attainable_ms"] for r in rows) / 1e3,
    }


def _conv_f32(B, res, cin, cout, k=3):
    """An f32 stride-1 SAME conv: FLOPs, and its input and output read and
    written once, weights once."""
    px = B * res * res
    return 2.0 * px * k * k * cin * cout, 4.0 * (px * (cin + cout) + k * k * cin * cout)


def gae_forward_ops(B, size, n_subs=16, n_ovls=4, n_colors=102, n_feats=64, latent=3):
    """Op list (name, flops, least f32 bytes) of ONE GAE forward (encode +
    decode, ``models/gae.py``) of a (B, size, size, n_colors) cube: the
    shared encoder and decoder over the B * G group images, the trunk over
    the B merged cubes. Elementwise work, the band gathers and the overlap
    average are left out."""
    G = -(-(n_colors - n_ovls) // (n_subs - n_ovls))
    ops = []

    def branch(tag, b, cin, feats, n_blocks):
        ops.append(Op(f"{tag}.head[{cin}->{feats}]", *_conv_f32(b, size, cin, feats)))
        for i in range(n_blocks):  # SSB: 3x3 ResBlock, then 1x1 ResAttentionBlock + CALayer
            for j in range(2):
                ops.append(Op(f"{tag}.ssb{i}.spa{j}", *_conv_f32(b, size, feats, feats)))
            for j in range(2):
                ops.append(Op(f"{tag}.ssb{i}.spc{j}", *_conv_f32(b, size, feats, feats, k=1)))
            red = feats // 3
            ops.append(Op(f"{tag}.ssb{i}.ca", 2 * 2.0 * b * feats * red,
                          4.0 * (2 * b * (feats + red) + 2 * feats * red)))

    bg = B * G
    branch("encoder", bg, n_subs, n_feats, 3)
    ops.append(Op(f"encoder.final[{n_feats}->{latent}]", *_conv_f32(bg, size, n_feats, latent)))
    branch("decoder", bg, latent, n_feats, 3)
    ops.append(Op(f"decoder.final[{n_feats}->{n_subs}]", *_conv_f32(bg, size, n_feats, n_subs)))
    branch("trunk", B, n_colors, 32, 2)
    ops.append(Op(f"final[32->{n_colors}]", *_conv_f32(B, size, 32, n_colors)))
    return ops
