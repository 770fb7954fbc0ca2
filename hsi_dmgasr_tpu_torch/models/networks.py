"""Network factory + weight init (reference model/networks.py), SR3 only.

Port of ``define_G`` / ``diffusion_for_phase`` / ``init_weights`` from
``hsi_dmgasr_tpu/models/networks.py`` for ``which_model_G = 'sr3'``
(continuous noise level, GroupNorm). ``init_weights`` follows the JAX
package's rules for ``init_type`` 'orthogonal' (what ``DDPMModel`` uses,
as the reference does at networks.py:110-112), 'normal' and 'kaiming':
every weight with two or more dims is re-drawn, every GroupNorm scale
goes to 1 and every other leaf, biases included, to 0. ``init_type``
'torch' (the default) is the port's own seeded init for modules the JAX
package initialises with flax's defaults (the GAE, the bench): torch's
U(+-1/sqrt(fan_in)) for conv and linear weights and biases, GroupNorm
scale 1 and bias 0. Every draw comes from an explicit generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..diffusion.gaussian import GaussianDiffusion
from ..diffusion.schedules import DiffusionSchedule
from .unet import UNet


def define_G(opt):
    """(unet, diffusion with the TRAIN schedule) from a reference-schema
    config dict. ``model.unet.fuse`` turns on the fused kernels."""
    model_opt = opt["model"]
    which = model_opt.get("which_model_G", "sr3")
    if which != "sr3":
        raise NotImplementedError(f"which_model_G={which!r}: only 'sr3' is ported")
    unet_opt = model_opt["unet"]
    unet = UNet(
        in_channel=unet_opt["in_channel"],
        out_channel=unet_opt["out_channel"],
        inner_channel=unet_opt["inner_channel"],
        norm_groups=unet_opt.get("norm_groups") or 32,
        channel_mults=tuple(unet_opt["channel_multiplier"]),
        attn_res=tuple(unet_opt["attn_res"]),
        res_blocks=unet_opt["res_blocks"],
        dropout=unet_opt.get("dropout") or 0.0,
        image_size=model_opt["diffusion"]["image_size"],
        fuse_blocks=bool(unet_opt.get("fuse")),
    )
    return unet, diffusion_for_phase(opt, "train")


def diffusion_for_phase(opt, phase):
    """GaussianDiffusion with the phase's beta schedule
    (model/model.py:87-94 schedule switching), ``model.loss_type`` (l1 by
    default) and ``model.diffusion.loss_weight`` ({"type": "min_snr",
    "gamma": cap}, the JAX package's beyond-reference knob)."""
    model_opt = opt["model"]
    if not model_opt["diffusion"].get("conditional", True):
        raise NotImplementedError("only the conditional (SR3) chain is ported")
    lw = model_opt["diffusion"].get("loss_weight")
    if lw is not None:
        kind = lw.get("type")
        if kind != "min_snr":
            raise ValueError(f"unknown model.diffusion.loss_weight type {kind!r}")
        lw = (kind, float(lw.get("gamma", 5.0)))
    return GaussianDiffusion(DiffusionSchedule.from_config(model_opt["beta_schedule"][phase]),
                             loss_type=model_opt.get("loss_type") or "l1", loss_weight=lw)


@torch.no_grad()
def init_weights(module, generator, init_type="torch", std=0.02, scale=1.0):
    """Re-initialise ``module`` in place from ``generator``; see the
    module docstring for the rules of each ``init_type``."""
    if init_type == "torch":
        return _torch_default_init(module, generator)
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            if init_type == "orthogonal":
                # rows = out, cols = in*kh*kw, as the JAX package's _orthogonal
                nn.init.orthogonal_(p, generator=generator)
            elif init_type == "normal":
                p.copy_(std * torch.randn(p.shape, generator=generator, dtype=p.dtype))
            elif init_type == "kaiming":
                fan_in = p[0].numel()
                p.copy_(scale * math.sqrt(2.0 / fan_in)
                        * torch.randn(p.shape, generator=generator, dtype=p.dtype))
            else:
                raise NotImplementedError(init_type)
        elif name.endswith("weight"):  # a GroupNorm scale
            p.fill_(1.0)
        else:
            p.zero_()
    return module


def _torch_default_init(module, generator):
    """Seeded torch-default init of every conv, linear and GroupNorm."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.copy_(torch.empty_like(m.weight).uniform_(-bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.copy_(torch.empty_like(m.bias).uniform_(-bound, bound, generator=generator))
        elif isinstance(m, nn.GroupNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    return module
