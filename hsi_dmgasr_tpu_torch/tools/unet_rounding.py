"""Which bf16 roundings of the fused Block move a full-width f32 UNet forward.

    python -m hsi_dmgasr_tpu_torch.tools.unet_rounding [--hw 64] [--batch 2]

Runs on the CPU. It builds ``configs/pavia_x4_r3.json``'s UNet at full
width with ``DDPMModel``'s seeded orthogonal weights and runs one forward
of seeded noise through the fused route, each Block computed by a plain
version that rounds to bf16 only what a variant names: x, the
activation, the weights, the residual. Each variant runs twice, its
convolutions summed in f32 and in f64, which stands for two correct
implementations that sum in another order ("vs_order": kernel against
plain); it is also held against the unfused f32 forward ("vs_unfused").
Prints one JSON line per variant with ``max_abs``, ``max_rel`` (over the
largest |reference|) and ``rms_rel``.
"""

from __future__ import annotations

import argparse
import json
import os
from unittest import mock

import torch
import torch.nn.functional as F

from ..config import load
from ..kernels.fused_conv import gn_scale_shift
from ..models import unet as unet_mod
from ..train.ddpm_model import DDPMModel

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> the roundings it applies, of (x, activation, weights, residual)
VARIANTS = {
    "all (the TPU kernel's)": (True, True, True, True),
    "x, activation, weights": (True, True, True, False),
    "activation, weights": (False, True, True, False),
    "weights only (the port's f32 path)": (False, False, True, False),
    "none": (False, False, False, False),
}


def _bf16(t):
    return t.to(torch.bfloat16).float()


def plain_block(rx, ra, rw, rr, f64):
    """A gn_swish_conv3x3 with the given roundings, summed in f64 or f32."""

    def block(x, gn_scale, gn_bias, kernel, bias, time_bias=None, residual=None, x2=None,
              stats_in=None, num_groups=32, eps=1e-5, emit_stats=False, res_kernel=None,
              res_bias=None, stats_in2=None, packed=None):
        dt = torch.float64 if f64 else torch.float32
        c = x.shape[-1]
        scale, shift = gn_scale_shift(x, gn_scale, gn_bias, x2, stats_in, stats_in2,
                                      num_groups, eps)

        def act(v, sc, sh):
            a = (_bf16(v) if rx else v) * sc[:, None, None, :] + sh[:, None, None, :]
            a = a * torch.sigmoid(a)
            return _bf16(a) if ra else a

        a = act(x, scale[:, :c], shift[:, :c])
        if x2 is not None:
            a = torch.cat([a, act(x2, scale[:, c:], shift[:, c:])], -1)
        w = (_bf16(kernel) if rw else kernel).permute(3, 2, 0, 1)
        out = F.conv2d(a.permute(0, 3, 1, 2).to(dt), w.to(dt), padding=1)
        out = out.float().permute(0, 2, 3, 1) + bias
        if time_bias is not None:
            out = out + time_bias[:, None, None, :]
        if residual is not None:
            out = out + (_bf16(residual) if rr else residual)
        results = [out]
        if emit_stats:
            results.append(torch.stack([out.sum(2), (out * out).sum(2)], 2))
        if res_kernel is not None:
            raw = x if x2 is None else torch.cat([x, x2], -1)
            raw = _bf16(raw) if rx else raw
            rk = (_bf16(res_kernel) if rw else res_kernel).reshape(raw.shape[-1], -1)
            res = (raw.to(dt) @ rk.to(dt)).float()
            results.append(res + res_bias if res_bias is not None else res)
        return results[0] if len(results) == 1 else tuple(results)

    return block


def divergence(y, ref):
    d = (y - ref).abs()
    return {"max_abs": d.max().item(), "max_rel": d.max().item() / ref.abs().max().item(),
            "rms_rel": (d.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hw", type=int, default=64, help="latent height and width")
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    opt = load(os.path.join(ROOT, "configs", "pavia_x4_r3.json"))
    opt["model"]["unet"]["fuse"] = True
    unet = DDPMModel(opt, seed=0, device="cpu").unet
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((args.batch, args.hw, args.hw, 6), generator=gen)
    t = torch.full((args.batch, 1), 0.5)
    blocks = [m for m in unet.modules() if isinstance(m, unet_mod.ResnetBlock)]
    with torch.no_grad():
        unet.fuse_blocks = False
        for b in blocks:
            b.fuse = False
        ref = unet(x, t)
        unet.fuse_blocks = True
        for b in blocks:
            b.fuse = True
        for name, flags in VARIANTS.items():
            y = {}
            for f64 in (False, True):
                with mock.patch.object(unet_mod, "gn_swish_conv3x3", plain_block(*flags, f64)):
                    y[f64] = unet(x, t)
            print(json.dumps({"variant": name, "vs_order": divergence(y[False], y[True]),
                              "vs_unfused": divergence(y[False], ref)}), flush=True)


if __name__ == "__main__":
    main()
