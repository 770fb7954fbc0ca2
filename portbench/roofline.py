"""The benchmark's analytic counts: operations and least bytes of the
program's work, computed from shapes, and the card's peaks.

A frozen copy of the arithmetic of the program's own counts (the port's
``utils/roofline.py``), kept here so that no change to the program can
move the yardstick, with three differences:

  * attention sits where the nominal resolution, counted down from the
    configuration's ``image_size``, is in ``attn_res`` (as the UNet places
    it), while the work is counted at the actual resolution of the
    latent: at a 512^2 latent, ``image_size`` 128 puts it at 64^2 and
    ``image_size`` 64 at 128^2;
  * bytes are counted in the call's dtype;
  * the fused Block's operations are counted once, whatever the kernel
    does to reach f32 accuracy.

Operations are matmul and conv multiply-adds x 2; normalisation and
activation work is left out. Both shares in this file are taken against
the card's dense bf16 peak and its memory bandwidth whatever the
precision, so none can pass 100 %.
"""

from __future__ import annotations

# (dense bf16 FLOP/s, memory bytes/s) by device name. H100 SXM: 989 TFLOP/s
# and 3.35 TB/s HBM3 (NVIDIA data sheet), at its 700 W limit.
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}


def peaks(device_name):
    """(FLOP/s, bytes/s) of the named card; raises for an unknown one."""
    for name, p in PEAKS.items():
        if device_name.lower().startswith(name.lower()):
            return p
    raise ValueError(f"no peaks for device {device_name!r}; known: {sorted(PEAKS)}")


def least_seconds(flops, nbytes, device_name):
    """The least time the card could take: the larger of the two bounds."""
    f, b = peaks(device_name)
    return max(flops / f, nbytes / b)


def kernel_share(span, work, device_name):
    """A kernel's share of its roofline, %: the least time of the span's
    calls, from each call's signature by ``work``, over the device time
    inside the span; None where the span saw no call."""
    if not span or span["ms"] <= 0:
        return None
    least = sum(n * least_seconds(*work(sig), device_name)
                for sig, (n, _) in span["by_signature"].items())
    return 100.0 * least / (span["ms"] / 1e3)


def peak_share(flops, seconds, device_name):
    """Operations over seconds as a share of the dense bf16 peak, %."""
    return 100.0 * flops / (seconds * peaks(device_name)[0])


# ------------------------------------------------------------------- kernels


def _tensor(sig, name):
    """(shape, bytes per element) of a tensor argument of a signature."""
    v = dict(sig).get(name)
    if not (isinstance(v, tuple) and v and v[0] == "tensor"):
        return None, 0
    return v[1], {"float32": 4, "bfloat16": 2, "float16": 2}[v[2]]


def fused_block_work(sig):
    """(operations, least bytes) of one ``gn_swish_conv3x3`` call from its
    signature: 2 * pixels * Cout * (Cin + C2) * (9 + a folded 1x1), each
    input and output once in the call's dtype, the weights once in bf16 (the
    kernel's), the moments in f32."""
    (b, h, w, c), es = _tensor(sig, "x")
    shape2, _ = _tensor(sig, "x2")
    c2 = shape2[-1] if shape2 else 0
    cout = _tensor(sig, "kernel")[0][-1]
    proj = _tensor(sig, "res_kernel")[0] is not None
    px, ct = b * h * w, c + c2
    flops = 2.0 * px * cout * ct * (9 + proj)
    nbytes = es * px * ct + es * px * cout * (1 + proj)
    if _tensor(sig, "residual")[0] is not None:
        nbytes += es * px * cout
    nbytes += 2.0 * (9 + proj) * ct * cout
    for name, ch in (("stats_in", c), ("stats_in2", c2)):
        if _tensor(sig, name)[0] is not None:
            nbytes += 4.0 * b * h * 2 * ch
    if dict(sig).get("emit_stats"):
        nbytes += 4.0 * b * h * 2 * cout
    return flops, nbytes


def flash_work(sig):
    """(operations, least bytes) of one ``flash_attention`` call: 4 B H S^2 D,
    and q, k, v and the output once in the call's dtype."""
    (b, s, h, d), es = _tensor(sig, "q")
    return 4.0 * b * h * s * s * d, 4.0 * es * b * s * h * d


# --------------------------------------------------------------- whole model


def _conv(B, res_in, cin, cout, stride=1, k=3):
    return 2.0 * B * (res_in // stride) ** 2 * k * k * cin * cout


def _resblock(B, res, cin, c2, cout):
    ct, px = cin + c2, B * res * res
    return (2.0 * px * 9 * ct * cout + (2.0 * px * ct * cout if ct != cout else 0.0)
            + 2.0 * px * 9 * cout * cout)


def _attention(B, res, c):
    px, n = B * res * res, res * res
    return 3 * 2.0 * px * c * c + 2 * 2.0 * B * n * n * c + 2.0 * px * c * c


def unet_flops(B, size, image_size, inner=64, mults=(1, 2, 4, 8, 8), res_blocks=2,
               attn_res=(16,), in_channel=6, out_channel=3):
    """Operations of ONE UNet forward at (B, size, size, in_channel)."""
    total = _conv(B, size, in_channel, inner)
    now, nominal = size, image_size
    feats, ch_in = [inner], inner
    for ind, m in enumerate(mults):
        ch = inner * m
        for _ in range(res_blocks):
            total += _resblock(B, now, ch_in, 0, ch)
            if nominal in attn_res:
                total += _attention(B, now, ch)
            feats.append(ch)
            ch_in = ch
        if ind != len(mults) - 1:
            total += _conv(B, now, ch, ch, stride=2)
            feats.append(ch)
            now //= 2
            nominal //= 2
    total += 2 * _resblock(B, now, ch_in, 0, ch_in) + _attention(B, now, ch_in)
    for ind in reversed(range(len(mults))):
        ch = inner * mults[ind]
        for _ in range(res_blocks + 1):
            total += _resblock(B, now, ch_in, feats.pop(), ch)
            if nominal in attn_res:
                total += _attention(B, now, ch)
            ch_in = ch
        if ind >= 1:
            # nearest x2 + conv3x3 as one conv with the composed 4x4 kernel:
            # each output pixel reads a 2x2 window
            total += 2.0 * B * (2 * now) ** 2 * 4 * ch * ch
            now *= 2
            nominal *= 2
    return total + _conv(B, now, ch_in, out_channel)


def gae_flops(B, size, n_subs=16, n_ovls=4, n_colors=102, n_feats=64, latent=3,
              encode=True, decode=True):
    """Operations of the GAE's encode and/or decode of a (B, size, size,
    n_colors) cube: the shared encoder and decoder over the B * G group
    images, the trunk over the B merged cubes."""
    G = -(-(n_colors - n_ovls) // (n_subs - n_ovls))

    def branch(b, cin, feats, n_blocks):
        red = feats // 3
        return (_conv(b, size, cin, feats)
                + n_blocks * (2 * _conv(b, size, feats, feats) + 2 * _conv(b, size, feats, feats, k=1)
                              + 2 * 2.0 * b * feats * red))

    bg, total = B * G, 0.0
    if encode:
        total += branch(bg, n_subs, n_feats, 3) + _conv(bg, size, n_feats, latent)
    if decode:
        total += (branch(bg, latent, n_feats, 3) + _conv(bg, size, n_feats, n_subs)
                  + branch(B, n_colors, 32, 2) + _conv(B, size, 32, n_colors))
    return total


def model_widths(cfg):
    """(UNet keyword arguments, GAE keyword arguments) of a configuration;
    None for a network it does not have (no ``model.unet``, no
    ``gae_widths``)."""
    unet = gae = None
    u = cfg.get("model", {}).get("unet")
    if u is not None:
        unet = dict(image_size=cfg["model"]["diffusion"]["image_size"],
                    inner=u["inner_channel"], mults=tuple(u["channel_multiplier"]),
                    res_blocks=u["res_blocks"], attn_res=tuple(u["attn_res"]),
                    in_channel=u["in_channel"], out_channel=u["out_channel"])
    if "gae_widths" in cfg:
        gae = {k: cfg["gae_widths"][k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")}
    return unet, gae


def cube_flops(cfg, batch, size, steps):
    """Operations of one ``super_resolve`` of ``batch`` cubes of size^2:
    the GAE's encode and decode and ``steps`` UNet forwards over the
    B * G latents."""
    unet, gae = model_widths(cfg)
    G = -(-(gae["n_colors"] - gae["n_ovls"]) // (gae["n_subs"] - gae["n_ovls"]))
    return gae_flops(batch, size, **gae) + steps * unet_flops(batch * G, size, **unet)


def train_step_flops(cfg, batch, size):
    """Operations of one stage-2 step on ``batch`` HR crops of size^2: the
    GAE encodes of the HR and SR crops, and the UNet's forward and backward
    (3 forwards) over the B * G latents."""
    unet, gae = model_widths(cfg)
    G = -(-(gae["n_colors"] - gae["n_ovls"]) // (gae["n_subs"] - gae["n_ovls"]))
    return (2 * gae_flops(batch, size, decode=False, **gae)
            + 3 * unet_flops(batch * G, size, **unet))
