"""Conditional Gaussian diffusion: the SR3 training loss and reverse chain.

Port of the conditional half of ``hsi_dmgasr_tpu/diffusion/gaussian.py``
(reference sr3_modules/diffusion.py:142-250). Schedule buffers are f64
numpy computed once; each step reads its scalars as f32, as the JAX
package does. The chain is a Python loop of ``_step`` calls.

Training (``p_losses``) keeps the continuous-gamma trick: one shared
t ~ U{1..T} per batch, then a per-sample gamma ~ U[sqrt(acp_{t-1}),
sqrt(acp_t)], on which the UNet is conditioned; the loss is the l1 or
l2 mean per sample, weighted per ``loss_weight``, then averaged.

Noise comes from an explicit ``torch.Generator``; ``x_init`` and
``noise_seq`` (T, *shape, ordered t = T-1..0) replace the drawn
Gaussians of the chain, and ``gamma`` and ``noise`` those of the loss,
for deterministic replay, e.g. against the JAX package.

The denoise function signature is ``denoise_fn(x, noise_level) -> eps``
where x already carries the conditioning concat. Only the conditional
chain with a clipped x_0 estimate is ported (the SR3 inference path).

Dtypes follow the JAX package's promotion: the chain state x, the noise
and every coefficient are f32 whatever the dtype of ``cond``; the concat
[cond, x] is f32; a bf16 eps is widened before it meets an f32 scalar,
so ``x_recon`` and ``mean`` are f32 products, as JAX's f32 scalars make
them (a Python float times a bf16 tensor would stay bf16 in torch).
"""

from __future__ import annotations

import numpy as np
import torch

from .schedules import DiffusionSchedule


class GaussianDiffusion:
    """Bundles a schedule with the reverse-chain math; holds no weights."""

    def __init__(self, schedule: DiffusionSchedule, loss_type="l1", loss_weight=None):
        """``loss_weight``: None (the reference's unweighted mean) or
        ("min_snr", cap), w = min(SNR, cap) / SNR with SNR = g^2 / (1 - g^2)."""
        self.schedule = schedule
        self.loss_type = loss_type
        self.loss_weight = loss_weight
        f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
        self._sacp_prev = f32(schedule.sqrt_alphas_cumprod_prev)
        self._srac = f32(schedule.sqrt_recip_alphas_cumprod)
        self._sracm1 = f32(schedule.sqrt_recipm1_alphas_cumprod)
        self._c1 = f32(schedule.posterior_mean_coef1)
        self._c2 = f32(schedule.posterior_mean_coef2)
        self._sigma = np.exp(np.float32(0.5) * f32(schedule.posterior_log_variance_clipped))

    def q_sample(self, x_start, continuous_sqrt_alpha_cumprod, noise):
        """g x0 + sqrt(1 - g^2) eps (diffusion.py:213-220); g broadcasts
        over trailing dims."""
        g = continuous_sqrt_alpha_cumprod
        return g * x_start + (1.0 - g ** 2) ** 0.5 * noise

    def _loss_w(self, gamma):
        """Per-sample weight from gamma; shape-preserving."""
        if self.loss_weight is None:
            return torch.ones_like(gamma)
        kind, cap = self.loss_weight
        if kind == "min_snr":
            g2 = (gamma.float() ** 2).clamp(1e-12, 1 - 1e-12)
            snr = g2 / (1.0 - g2)
            return torch.clamp(cap / snr, max=1.0)
        raise NotImplementedError(self.loss_weight)

    def p_losses(self, denoise_fn, x_hr, x_sr, generator=None, gamma=None, noise=None):
        """Continuous-gamma denoising loss (diffusion.py:222-250) of the
        target ``x_hr`` (B, H, W, C) conditioned on ``x_sr``, which is
        concatenated first (torch.cat([SR, noisy]), diffusion.py:247).
        ``gamma`` (B,) and ``noise`` replace the drawn ones; t, gamma and
        noise are drawn from ``generator`` in that order."""
        b, dev = x_hr.shape[0], x_hr.device
        if gamma is None:
            # drawn and gathered on the device: no host sync per step
            t = torch.randint(1, self.schedule.num_timesteps + 1, (), generator=generator,
                              device=dev)
            sacp = torch.as_tensor(self._sacp_prev, device=dev)
            lo, hi = sacp[t - 1], sacp[t]
            u = torch.rand((b,), generator=generator, dtype=torch.float32, device=dev)
            gamma = u * (hi - lo) + lo
        gamma = torch.as_tensor(gamma, dtype=torch.float32, device=dev)
        if noise is None:
            noise = torch.randn(x_hr.shape, generator=generator, dtype=x_hr.dtype, device=dev)
        noise = torch.as_tensor(noise, dtype=x_hr.dtype, device=dev)
        x_noisy = self.q_sample(x_hr, gamma[:, None, None, None], noise)
        eps_pred = denoise_fn(torch.cat([x_sr, x_noisy], -1), gamma[:, None])
        err = noise - eps_pred
        if self.loss_type == "l1":
            per = err.abs().mean((1, 2, 3))
        elif self.loss_type == "l2":
            per = (err ** 2).mean((1, 2, 3))
        else:
            raise NotImplementedError(self.loss_type)
        return (self._loss_w(gamma) * per).mean()

    def _step(self, denoise_fn, x, t, cond, noise=None, generator=None):
        """One reverse step == reference p_sample (diffusion.py:142-175).
        ``noise`` overrides the drawn Gaussian; it is zero at t = 0."""
        noise_level = torch.full((x.shape[0], 1), float(self._sacp_prev[t + 1]),
                                 dtype=torch.float32, device=x.device)
        eps = denoise_fn(torch.cat([cond.to(x.dtype), x], -1), noise_level).float()
        x_recon = float(self._srac[t]) * x - float(self._sracm1[t]) * eps
        x_recon = x_recon.clamp(-1.0, 1.0)
        mean = float(self._c1[t]) * x_recon + float(self._c2[t]) * x
        if t == 0:
            return mean
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                                device=x.device)
        return mean + noise * float(self._sigma[t])

    def init_from_cond(self, cond, t_start, generator=None):
        """Truncated-chain start x_t0 = g_t0 cond + sqrt(1 - g^2) eps
        (CCDF-style; the reference always starts from pure noise)."""
        g = self._sacp_prev[t_start]
        eps = torch.randn(cond.shape, generator=generator, dtype=torch.float32,
                          device=cond.device)
        return float(g) * cond.float() + float(np.sqrt(np.float32(1.0) - g * g)) * eps

    def sample_loop(self, denoise_fn, cond, x_init=None, noise_seq=None,
                    t_start=None, generator=None):
        """Reverse chain conditioned on ``cond`` from x_T (or from
        ``init_from_cond`` at ``t_start``, running only the last t_start
        steps)."""
        T = self.schedule.num_timesteps
        t0 = T if t_start is None else int(t_start)
        if not 0 < t0 <= T:
            raise ValueError(f"t_start {t_start} outside (0, {T}]")
        if x_init is not None:
            x = torch.as_tensor(x_init, dtype=torch.float32, device=cond.device)
        elif t_start is not None:
            x = self.init_from_cond(cond, t0, generator)
        else:
            x = torch.randn(cond.shape, generator=generator, dtype=torch.float32,
                            device=cond.device)
        nz = None
        if noise_seq is not None:
            nz = torch.as_tensor(noise_seq, dtype=torch.float32, device=x.device)[-t0:]
        for i, t in enumerate(range(t0 - 1, -1, -1)):
            x = self._step(denoise_fn, x, t, cond,
                           noise=None if nz is None else nz[i], generator=generator)
        return x
