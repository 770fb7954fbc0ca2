"""Gaussian diffusion: the SR3 training loss and the reverse chains.

Port of ``hsi_dmgasr_tpu/diffusion/gaussian.py`` (reference
sr3_modules/diffusion.py:142-250 and ddpm_modules/diffusion.py). Schedule
buffers are f64 numpy computed once; each step reads its scalars as f32,
as the JAX package does. A chain is a Python loop of ``_step`` calls.

Training (``p_losses``) keeps the continuous-gamma trick: one shared
t ~ U{1..T} per batch, then a per-sample gamma ~ U[sqrt(acp_{t-1}),
sqrt(acp_t)], on which the UNet is conditioned; the loss is the l1 or
l2 mean per sample, weighted per ``loss_weight``, then averaged.
``DDPMDiffusion`` is the discrete-t variant: one t ~ U{0..T-1} per
sample, fed to the UNet as an int32 (B,) tensor.

Sampling: ``sample_loop``, the ancestral chain, conditioned on ``cond``
or unconditional from a ``shape`` (``super_resolution``, ``sample``),
optionally returning every state; ``ddim_sample_loop``, the DDIM
sampler over ``steps`` evenly strided timesteps (deterministic at
eta = 0); ``DDPMDiffusion.interpolate``, the latent interpolation.

Noise comes from an explicit ``torch.Generator``; ``x_init`` and
``noise_seq`` (one noise per step, in the order the steps run) replace
the drawn Gaussians of a chain, and ``gamma``/``t`` and ``noise`` those
of the loss, for deterministic replay, e.g. against the JAX package.
``split_generator`` derives one generator per chain of a sequence (a
latent chunk, a tile), as ``jax.random.split`` gives one key each.

The denoise function signature is ``denoise_fn(x, noise_level) -> eps``
where x already carries the conditioning concat.

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


_f32 = np.float32


def split_generator(generator, n):
    """``n`` generators on ``generator``'s device, each seeded from one draw
    of it, in order: the counterpart of ``jax.random.split(key, n)``."""
    seeds = torch.randint(2 ** 62, (n,), generator=generator, device=generator.device)
    return [torch.Generator(device=generator.device).manual_seed(s) for s in seeds.tolist()]


class GaussianDiffusion:
    """Bundles a schedule with the chain math; holds no weights."""

    def __init__(self, schedule: DiffusionSchedule, loss_type="l1", loss_weight=None,
                 conditional=True, clip_denoised=True):
        """``loss_weight``: None (the reference's unweighted mean) or
        ("min_snr", cap), w = min(SNR, cap) / SNR with SNR = g^2 / (1 - g^2).
        ``conditional``: the loss concatenates ``x_sr`` before the noisy
        target; ``clip_denoised``: the chains clip their x_0 estimate to
        [-1, 1]."""
        self.schedule = schedule
        self.loss_type = loss_type
        self.loss_weight = loss_weight
        self.conditional = conditional
        self.clip_denoised = clip_denoised
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

    def _input(self, x_sr, x_noisy):
        return torch.cat([x_sr, x_noisy], -1) if self.conditional else x_noisy

    def _loss(self, noise, eps_pred, weight):
        err = noise - eps_pred
        if self.loss_type == "l1":
            per = err.abs().mean((1, 2, 3))
        elif self.loss_type == "l2":
            per = (err ** 2).mean((1, 2, 3))
        else:
            raise NotImplementedError(self.loss_type)
        return (self._loss_w(weight) * per).mean()

    def p_losses(self, denoise_fn, x_hr, x_sr=None, generator=None, gamma=None, noise=None):
        """Continuous-gamma denoising loss (diffusion.py:222-250) of the
        target ``x_hr`` (B, H, W, C), conditioned on ``x_sr`` when the
        diffusion is conditional (concatenated first: torch.cat([SR,
        noisy]), diffusion.py:247). ``gamma`` (B,) and ``noise`` replace
        the drawn ones; t, gamma and noise are drawn from ``generator`` in
        that order."""
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
        return self._loss(noise, denoise_fn(self._input(x_sr, x_noisy), gamma[:, None]), gamma)

    def _time_input(self, t, b, device):
        """What the UNet is conditioned on at step t: the continuous noise
        level sqrt(acp_prev[t + 1]), (B, 1) f32."""
        return torch.full((b, 1), float(self._sacp_prev[t + 1]), dtype=torch.float32,
                          device=device)

    def _step(self, denoise_fn, x, t, cond, noise=None, generator=None):
        """One reverse step == reference p_sample (diffusion.py:142-175),
        conditioned on ``cond`` unless it is None. ``noise`` overrides the
        drawn Gaussian; it is zero at t = 0."""
        inp = torch.cat([cond.to(x.dtype), x], -1) if cond is not None else x
        eps = denoise_fn(inp, self._time_input(t, x.shape[0], x.device)).float()
        x_recon = float(self._srac[t]) * x - float(self._sracm1[t]) * eps
        if self.clip_denoised:
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

    @staticmethod
    def _chain_device(cond, x_init, generator):
        if cond is not None:
            return cond.device
        if isinstance(x_init, torch.Tensor):
            return x_init.device
        return generator.device if generator is not None else torch.device("cpu")

    def sample_loop(self, denoise_fn, cond=None, x_init=None, noise_seq=None,
                    t_start=None, generator=None, shape=None, return_intermediates=False):
        """The ancestral reverse chain (diffusion.py:177-201), conditioned
        on ``cond``, or unconditional from pure noise of ``shape`` (on the
        generator's device). ``t_start`` runs only the last t_start steps
        from ``init_from_cond`` (or from ``x_init``); ``noise_seq`` holds
        T states' noise, t = T-1..0, of which the last t_start are used.
        ``return_intermediates`` also returns the state after every step,
        stacked (steps, B, H, W, C)."""
        T = self.schedule.num_timesteps
        t0 = T if t_start is None else int(t_start)
        if not 0 < t0 <= T:
            raise ValueError(f"t_start {t_start} outside (0, {T}]")
        if t_start is not None and cond is None and x_init is None:
            raise ValueError("t_start needs cond (or x_init)")
        if cond is not None:
            shape = cond.shape
        device = self._chain_device(cond, x_init, generator)
        if x_init is not None:
            x = torch.as_tensor(x_init, dtype=torch.float32, device=device)
        elif t_start is not None:
            x = self.init_from_cond(cond, t0, generator)
        else:
            x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                            device=device)
        nz = None
        if noise_seq is not None:
            nz = torch.as_tensor(noise_seq, dtype=torch.float32, device=x.device)[-t0:]
        states = []
        for i, t in enumerate(range(t0 - 1, -1, -1)):
            x = self._step(denoise_fn, x, t, cond,
                           noise=None if nz is None else nz[i], generator=generator)
            if return_intermediates:
                states.append(x)
        if return_intermediates:
            return x, torch.stack(states)
        return x

    def super_resolution(self, denoise_fn, cond, return_intermediates=False, generator=None):
        """Conditional sampling seeded from noise (diffusion.py:209-211)."""
        return self.sample_loop(denoise_fn, cond=cond, generator=generator,
                                return_intermediates=return_intermediates)

    def sample(self, denoise_fn, batch_size, image_size, channels, return_intermediates=False,
               generator=None):
        """Unconditional generation (diffusion.py:203-207), NHWC."""
        return self.sample_loop(denoise_fn, shape=(batch_size, image_size, image_size, channels),
                                generator=generator,
                                return_intermediates=return_intermediates)

    def ddim_timesteps(self, steps=None):
        """The DDIM chain's timesteps, T-1 first: ``steps`` evenly strided
        over [0, T-1], rounded half to even (numpy's round)."""
        T = self.schedule.num_timesteps
        return np.linspace(0, T - 1, steps or T).round().astype(np.int32)[::-1]

    def ddim_sample_loop(self, denoise_fn, shape=None, cond=None, steps=None, eta=0.0,
                         x_init=None, noise_seq=None, generator=None):
        """DDIM sampler (Song et al. 2020), beyond the reference: ``steps``
        timesteps of the trained schedule (``ddim_timesteps``), the UNet
        conditioned on sqrt(acp_prev[t + 1]) as in the ancestral chain;
        deterministic at eta = 0. x_T is pure noise (or ``x_init``), never
        ``init_from_cond``; ``noise_seq`` holds one noise per step, in the
        order the steps run (the last step adds none)."""
        ts = self.ddim_timesteps(steps)
        t_next = np.append(ts[1:], -1)
        acp = np.append(1.0, self.schedule.alphas_cumprod).astype(_f32)  # acp[t + 1] = a_t
        if cond is not None:
            shape = cond.shape
        device = self._chain_device(cond, x_init, generator)
        if x_init is not None:
            x = torch.as_tensor(x_init, dtype=torch.float32, device=device)
        else:
            x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                            device=device)
        nz = None if noise_seq is None else torch.as_tensor(noise_seq, dtype=torch.float32,
                                                            device=device)
        one, eta = _f32(1.0), _f32(eta)
        for i, (t, tn) in enumerate(zip(ts, t_next)):
            inp = torch.cat([cond.to(x.dtype), x], -1) if cond is not None else x
            noise_level = torch.full((x.shape[0], 1), float(self._sacp_prev[t + 1]),
                                     dtype=torch.float32, device=device)
            eps = denoise_fn(inp, noise_level).float()
            a_t, a_n = acp[t + 1], acp[tn + 1]  # tn == -1 -> acp[0] == 1
            x0_pred = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
            if self.clip_denoised:
                x0_pred = x0_pred.clamp(-1.0, 1.0)
            sigma = eta * np.sqrt((one - a_n) / (one - a_t) * (one - a_t / a_n))
            dir_c = np.sqrt(np.maximum(one - a_n - sigma * sigma, _f32(0.0)))
            x = float(np.sqrt(a_n)) * x0_pred + float(dir_c) * eps
            if tn >= 0 and sigma != 0:
                noise = nz[i] if nz is not None else torch.randn(
                    x.shape, generator=generator, dtype=torch.float32, device=device)
                x = x + float(sigma) * noise
        return x


class DDPMDiffusion(GaussianDiffusion):
    """The discrete-timestep variant (ddpm_modules/diffusion.py:64-67
    extract, :278-294 p_losses): the UNet is fed the integer t."""

    def __init__(self, schedule: DiffusionSchedule, **kw):
        super().__init__(schedule, **kw)
        self._sac = np.asarray(schedule.sqrt_alphas_cumprod, np.float32)
        self._som = np.asarray(schedule.sqrt_one_minus_alphas_cumprod, np.float32)

    def p_losses(self, denoise_fn, x_hr, x_sr=None, generator=None, t=None, noise=None):
        """The loss at one t ~ U{0..T-1} per sample: x_noisy =
        sqrt(acp_t) x_hr + sqrt(1 - acp_t) noise. ``t`` (B,) and ``noise``
        replace the draws, made from ``generator`` in that order."""
        b, dev = x_hr.shape[0], x_hr.device
        if t is None:
            t = torch.randint(0, self.schedule.num_timesteps, (b,), generator=generator,
                              device=dev)
        t = torch.as_tensor(t, dtype=torch.int64, device=dev)
        if noise is None:
            noise = torch.randn(x_hr.shape, generator=generator, dtype=x_hr.dtype, device=dev)
        noise = torch.as_tensor(noise, dtype=x_hr.dtype, device=dev)
        sac = torch.as_tensor(self._sac, device=dev)[t]
        som = torch.as_tensor(self._som, device=dev)[t]
        x_noisy = sac[:, None, None, None] * x_hr + som[:, None, None, None] * noise
        return self._loss(noise, denoise_fn(self._input(x_sr, x_noisy), t.to(torch.int32)), sac)

    def _time_input(self, t, b, device):
        """The integer timestep, (B,) int32."""
        return torch.full((b,), int(t), dtype=torch.int32, device=device)

    def interpolate(self, denoise_fn, x1, x2, t=None, lam=0.5, generator=None, q_noise=None,
                    noise_seq=None):
        """Latent interpolation (ddpm_modules/diffusion.py:242-257): x1 and
        x2 diffused to t (T-1 by default), mixed (1 - lam) : lam, then the
        unconditional chain from t - 1 down to 0. ``q_noise`` (the two
        diffusion noises) and ``noise_seq`` (one per step) replace the
        draws."""
        t = self.schedule.num_timesteps - 1 if t is None else int(t)
        x1 = torch.as_tensor(x1, dtype=torch.float32)
        x2 = torch.as_tensor(x2, dtype=torch.float32, device=x1.device)
        if q_noise is None:
            q_noise = [torch.randn(x.shape, generator=generator, dtype=torch.float32,
                                   device=x1.device) for x in (x1, x2)]
        n1, n2 = (torch.as_tensor(n, dtype=torch.float32, device=x1.device) for n in q_noise)
        sac, som = float(self._sac[t]), float(self._som[t])
        img = (1 - lam) * (sac * x1 + som * n1) + lam * (sac * x2 + som * n2)
        nz = None if noise_seq is None else torch.as_tensor(noise_seq, dtype=torch.float32,
                                                            device=x1.device)
        for i, ti in enumerate(range(t - 1, -1, -1)):
            img = self._step(denoise_fn, img, ti, None,
                             noise=None if nz is None else nz[i], generator=generator)
        return img
