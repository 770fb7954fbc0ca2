"""The plain reference of DMGASR inference: GAE encode, the latent affine,
the SR3 ancestral chain over every band group's latent at once, decode and
clip (github.com/handsomewzy/HSI-DMGASR ``sr_gae.py``,
``model/sr3_modules/diffusion.py``).

Schedules are computed in float64 numpy and read as float32 scalars. The
chain starts at ``t_start`` from sqrt(acp_prev[t_start]) cond +
sqrt(1 - that^2) eps when the configuration truncates it, else from eps.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def betas(sched):
    """The beta schedule of a ``beta_schedule`` phase (cosine or linear)."""
    n = sched["n_timestep"]
    if sched["schedule"] == "cosine":
        s = 8e-3
        t = np.arange(n + 1, dtype=np.float64) / n + s
        a = np.cos(t / (1 + s) * math.pi / 2) ** 2
        a = a / a[0]
        return np.clip(1 - a[1:] / a[:-1], None, 0.999)
    if sched["schedule"] == "linear":
        return np.linspace(sched["linear_start"], sched["linear_end"], n, dtype=np.float64)
    raise NotImplementedError(sched["schedule"])


class Schedule:
    """The posterior coefficients of one phase, as float32 numpy."""

    def __init__(self, sched):
        b = betas(sched)
        acp = np.cumprod(1.0 - b)
        acp_prev = np.append(1.0, acp[:-1])
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        self.T = len(b)
        self.sacp_prev = f32(np.sqrt(np.append(1.0, acp)))
        self.srac = f32(np.sqrt(1.0 / acp))
        self.sracm1 = f32(np.sqrt(1.0 / acp - 1))
        var = b * (1.0 - acp_prev) / (1.0 - acp)
        self.c1 = f32(b * np.sqrt(acp_prev) / (1.0 - acp))
        self.c2 = f32((1.0 - acp_prev) * np.sqrt(1.0 - b) / (1.0 - acp))
        self.sigma = np.exp(np.float32(0.5) * f32(np.log(np.maximum(var, 1e-20))))


def chain_start(cfg):
    """The number of steps the configured chain runs."""
    d = cfg["model"]["diffusion"]
    return int(d["t_start"]) if d.get("t_start") else cfg["model"]["beta_schedule"]["val"]["n_timestep"]


def latent_affine(cfg):
    g = cfg.get("gae") or {}
    return float(g.get("latent_shift") or 0.0), float(g.get("latent_scale") or 1.0)


@torch.no_grad()
def super_resolve(gae, unet, cube, eps, noise_seq, cfg, prec):
    """cube (B, H, W, C) in [0, 1] -> (B, H, W, C) in [0, 1]. ``eps``: the
    chain's start noise, ``noise_seq``: the noise of each step in the order
    the steps run (the last one unused), both in the folded latent shape
    (B * G, H, W, 3)."""
    shift, scale = latent_affine(cfg)
    sch = Schedule(cfg["model"]["beta_schedule"]["val"])
    b = cube.shape[0]
    x_cube = cube.permute(0, 3, 1, 2).float()
    cond = (gae.encode(x_cube) - shift) * scale
    _, g, lc, h, w = cond.shape
    cond = cond.reshape(b * g, lc, h, w)
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    t0 = chain_start(cfg)
    eps = nchw(eps)
    if cfg["model"]["diffusion"].get("t_start"):
        gm = sch.sacp_prev[t0]
        x = float(gm) * cond + float(np.sqrt(np.float32(1.0) - gm * gm)) * eps
    else:
        x = eps
    for i, t in enumerate(range(t0 - 1, -1, -1)):
        level = torch.full((x.shape[0], 1), float(sch.sacp_prev[t + 1]), device=x.device)
        e = unet(torch.cat([cond, x], 1), level, prec)
        x_recon = (float(sch.srac[t]) * x - float(sch.sracm1[t]) * e).clamp(-1.0, 1.0)
        x = float(sch.c1[t]) * x_recon + float(sch.c2[t]) * x
        if t > 0:
            x = x + nchw(noise_seq[i]) * float(sch.sigma[t])
    z = (x.reshape(b, g, lc, h, w) / scale) + shift
    return gae.decode(z).clamp(0.0, 1.0).permute(0, 2, 3, 1)
