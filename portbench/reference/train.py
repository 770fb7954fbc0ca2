"""The plain reference of DMGASR's stage-2 training step (github.com/
handsomewzy/HSI-DMGASR ``sr_gae.py`` and ``model/sr3_modules/
diffusion.py`` ``p_losses``), in plain PyTorch:

  HR crops -> the SR pair by MATLAB bicubic down and up (``imresize``) ->
  both GAE-encoded (frozen), the latent affine, the band groups folded into
  the batch -> one t ~ U{1..T} for the batch, gamma ~ U[sqrt(acp_{t-1}),
  sqrt(acp_t)] per latent, noise -> the UNet on [SR latent, gamma HR +
  sqrt(1 - gamma^2) noise] with dropout on Block 2 of every resblock -> the
  L1 loss of the noise (mean per latent, then over the batch) -> Adam
  (betas 0.9 / 0.999, eps 1e-8) at lr x the schedule's factor of the update
  -> the EMA of the weights, from the initial ones.

The draws are the benchmark's: one generator per step, from which the
step draws t, the batch's uniforms, the noise and then each dropout mask
(keep with probability 1 - p, drawn channels-last) in the order the
forward runs the Blocks.
"""

from __future__ import annotations

import math

import torch

from . import dmgasr, imresize, nets

BETAS, EPS = (0.9, 0.999), 1e-8


def augment(x, mode):
    """The 8 flips and rotations of an (H, W, C) crop: rot90 by mode // 2,
    then flipud on odd modes."""
    x = torch.rot90(x, mode // 2, (0, 1))
    return x.flip(0) if mode % 2 else x


def crops(scenes, gen, batch, size):
    """(batch, size, size, C) crops: scene, row, col and mode drawn from
    ``gen`` in that order."""
    s, h, w, _ = scenes.shape
    kw = dict(generator=gen, device=scenes.device)
    idx = torch.randint(0, s, (batch,), **kw).tolist()
    row = torch.randint(0, h - size + 1, (batch,), **kw).tolist()
    col = torch.randint(0, w - size + 1, (batch,), **kw).tolist()
    mode = torch.randint(0, 8, (batch,), **kw).tolist()
    return torch.stack([augment(scenes[i, r:r + size, c:c + size], m)
                        for i, r, c, m in zip(idx, row, col, mode)])


def lr_factor(cfg, k):
    sched = (cfg["train"]["optimizer"] or {}).get("lr_schedule")
    if not sched:
        return 1.0
    if sched["type"] == "cosine":
        d, a = sched["decay_steps"], sched.get("alpha", 0.0)
        return (1.0 - a) * 0.5 * (1.0 + math.cos(math.pi * min(k, d) / d)) + a
    raise NotImplementedError(sched["type"])


def dropout_from(gen, p):
    def drop(a):
        b, c, h, w = a.shape
        keep = torch.empty((b, h, w, c), device=a.device).bernoulli_(1.0 - p, generator=gen)
        return torch.where(keep.permute(0, 3, 1, 2).bool(), a / (1.0 - p),
                           torch.zeros((), dtype=a.dtype, device=a.device))
    return drop


def latents(gae, cube, cfg):
    """(B, H, W, C) -> the folded, affine (B * G, 3, H, W) latents."""
    shift, scale = dmgasr.latent_affine(cfg)
    with torch.no_grad():
        z = (gae.encode(cube.permute(0, 3, 1, 2)) - shift) * scale
    b, g, c, h, w = z.shape
    return z.reshape(b * g, c, h, w)


def steps(cfg, gae, unet, batches, gens):
    """Run one training step per (HR batch, generator), from ``unet``'s
    weights. Returns each step's loss, the first step's gradients and EMA,
    and the weights after the last step (by parameter name)."""
    names = [n for n, _ in unet.named_parameters()]
    params = [p for _, p in unet.named_parameters()]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    ema = [p.detach().clone() for p in params]
    sch = dmgasr.Schedule(cfg["model"]["beta_schedule"]["train"])
    sacp = torch.as_tensor(sch.sacp_prev, device=params[0].device)
    lr0 = cfg["train"]["optimizer"]["lr"]
    decay = cfg["train"]["ema_scheduler"]["ema_decay"]
    p_drop = cfg["model"]["unet"]["dropout"]
    scale = cfg["scale"]
    prec = nets.Precision()
    losses, first, first_ema = [], None, None
    for k, (hr, gen) in enumerate(zip(batches, gens)):
        sr = imresize.degrade(hr, scale)
        z_hr, z_sr = latents(gae, hr, cfg), latents(gae, sr, cfg)
        n, c, h, w = z_hr.shape
        t = torch.randint(1, sch.T + 1, (), generator=gen, device=hr.device)
        u = torch.rand((n,), generator=gen, device=hr.device)
        gamma = u * (sacp[t] - sacp[t - 1]) + sacp[t - 1]
        noise = torch.randn((n, h, w, c), generator=gen, device=hr.device).permute(0, 3, 1, 2)
        g4 = gamma[:, None, None, None]
        x_noisy = g4 * z_hr + (1.0 - g4 ** 2) ** 0.5 * noise
        eps = unet(torch.cat([z_sr, x_noisy], 1), gamma[:, None], prec, dropout_from(gen, p_drop))
        loss = (noise - eps).abs().mean((1, 2, 3)).mean()
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if first is None:
            first = {nm: g.detach().clone() for nm, g in zip(names, grads)}
        lr = lr0 * lr_factor(cfg, k)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(params, grads)):
                m[i].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v[i].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                bc1, bc2 = 1 - BETAS[0] ** (k + 1), 1 - BETAS[1] ** (k + 1)
                p.sub_(lr / bc1 * m[i] / ((v[i] / bc2).sqrt() + EPS))
                ema[i].mul_(decay).add_(p, alpha=1 - decay)
        if first_ema is None:
            first_ema = {nm: e.clone() for nm, e in zip(names, ema)}
    return {"losses": losses, "first_grads": first,
            "params": {nm: p.detach() for nm, p in zip(names, params)},
            "ema": first_ema}
