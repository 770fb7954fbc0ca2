"""DMGASR pipeline: GAE latent space + SR3 conditional diffusion.

Port of ``hsi_dmgasr_tpu/pipeline.py`` (reference sr_gae.py:221-250 and
436-496):

  * ``train_step`` / ``train_step_from_hr``: GAE-encode the HR and SR
    cubes with the frozen GAE and train the diffusion on the latent
    pairs, all G band groups folded into one (B*G)-batch step
    (``per_group=True``: the reference's G sequential steps). From HR
    crops alone the SR cube is made on the device: MATLAB-bicubic down,
    clip, up, clip (``data/imresize.py:make_imresize_torch``).
  * ``super_resolve``: encode the bicubic-upsampled LR cube into G latents,
    apply the latent affine, fold the groups into the batch, run the
    reverse chain once for all of them, unfold, GAE-decode, clip to [0, 1];
    and the HSI metric suite.

Tiled and spatially sharded inference are not ported yet.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .data.imresize import make_imresize_torch
from .device import resolve_device
from .evalhsi.metrics import color_correction as _color_correction
from .evalhsi.metrics import quality_assessment
from .evalhsi.torch_metrics import quality_assessment_torch
from .io.convert_torch import load_state_dict
from .models.gae import GAE
from .models.networks import init_weights
from .train.ddpm_model import DDPMModel


class DMGASRPipeline:
    def __init__(self, opt, gae_state, gae_config, ddpm=None, seed=0, device=None):
        """gae_state: a reference-layout GAE state_dict, or None for the
        seeded init. ``device`` defaults to CUDA and raises without it;
        pass ``device="cpu"`` to run on the CPU."""
        self.opt = opt
        self.device = resolve_device(device)
        self.gae = GAE(n_subs=gae_config["n_subs"], n_ovls=gae_config["n_ovls"],
                       n_colors=gae_config["n_colors"], n_feats=gae_config["n_feats"])
        if gae_state is None:
            init_weights(self.gae, torch.Generator().manual_seed(seed))
        else:
            load_state_dict(self.gae, gae_state)
        self.gae.to(self.device).eval()
        self.G = gae_config["G"]
        self.n_colors = gae_config["n_colors"]
        # latent affine z' = (z - shift) * scale (pipeline.py:52-66 of the
        # JAX package); identity by default
        gae_opt = (opt or {}).get("gae") or {}
        self.latent_shift = float(gae_opt.get("latent_shift") or 0.0)
        self.latent_scale = float(gae_opt.get("latent_scale") or 1.0)
        self.ddpm = ddpm if ddpm is not None else DDPMModel(opt, seed=seed, device=self.device)
        self._degrade_cache = {}

    # ------------------------------------------------------------ stages

    def _encode(self, cube):
        x = torch.as_tensor(cube, dtype=torch.float32, device=self.device)
        return (self.gae.encode(x) - self.latent_shift) * self.latent_scale

    @torch.inference_mode()
    def encode(self, cube):
        """(B, H, W, C) cube -> (B, G, h, w, 3) latents."""
        return self._encode(cube)

    @torch.inference_mode()
    def decode(self, z):
        return self.gae.decode(z / self.latent_scale + self.latent_shift)

    @staticmethod
    def _fold(z):
        """(B, G, h, w, c) -> (B*G, h, w, c)."""
        b, g, h, w, c = z.shape
        return z.reshape(b * g, h, w, c)

    @staticmethod
    def _unfold(z, b):
        bg, h, w, c = z.shape
        return z.reshape(b, bg // b, h, w, c)

    # ------------------------------------------------------------- train

    def _degrade_fn(self, hw, scale):
        """HR -> bicubic-up(LR) on the device: MATLAB-bicubic down, clip to
        [0, 1], up, clip (the host dataset's HStrain.py:61-63 pair)."""
        ck = (tuple(hw), scale)
        if ck not in self._degrade_cache:
            lr_hw = (hw[0] // scale, hw[1] // scale)
            down = make_imresize_torch(hw, output_shape=lr_hw, device=self.device)
            up = make_imresize_torch(lr_hw, output_shape=hw, device=self.device)
            self._degrade_cache[ck] = lambda hr: up(down(hr).clamp(0.0, 1.0)).clamp(0.0, 1.0)
        return self._degrade_cache[ck]

    def _to_f32(self, x):
        """A batch (numpy or tensor, f16/bf16 transfers included) as an f32
        tensor on the device."""
        return torch.as_tensor(x, device=self.device).float()

    def train_step_from_hr(self, hr, scale=4, generator=None, per_group=False):
        """Training step from HR crops only; SR derived on the device."""
        hr = self._to_f32(hr)
        with torch.no_grad():
            sr = self._degrade_fn((hr.shape[1], hr.shape[2]), scale)(hr)
        return self.train_step({"HR": hr, "SR": sr}, generator=generator, per_group=per_group)

    def train_step(self, batch, generator=None, per_group=False):
        """One diffusion update from a cube batch {'HR','SR'} (NHWC). The
        GAE stays frozen; its latents are made under no_grad (not in
        inference mode, whose tensors autograd cannot save)."""
        with torch.no_grad():
            z_hr = self._encode(self._to_f32(batch["HR"]))
            z_sr = self._encode(self._to_f32(batch["SR"]))
        if per_group:
            # reference dynamics: one optimizer step per band group
            # (sr_gae.py:245-250), each with fresh draws
            losses = [self.ddpm.train_step({"HR": z_hr[:, g], "SR": z_sr[:, g]}, generator)
                      for g in range(self.G)]
            return torch.stack(losses).mean()
        return self.ddpm.train_step({"HR": self._fold(z_hr), "SR": self._fold(z_sr)}, generator)

    # --------------------------------------------------------- inference

    def super_resolve(self, sr_cube, generator=None, x_init=None, noise_seq=None):
        """Full DMGASR inference on bicubic-upsampled LR cubes (B, H, W, C)
        in [0, 1]. ``x_init``/``noise_seq`` (folded latent shape) replay
        given noise through the chain."""
        b = sr_cube.shape[0]
        cond = self._fold(self.encode(sr_cube))
        z_out = self._unfold(self.ddpm.super_resolution(
            cond, generator=generator, x_init=x_init, noise_seq=noise_seq), b)
        return self.decode(z_out).clamp(0.0, 1.0)

    def reconstruct(self, cube):
        """GAE round trip (no diffusion): the stage-1 quality check."""
        return self.decode(self.encode(cube)).clamp(0.0, 1.0)

    # -------------------------------------------------------------- eval

    def evaluate(self, sr_cube, hr_cube, ratio=4, use_color_correction=False,
                 on_device=True, generator=None, x_init=None, noise_seq=None):
        """Super-resolve + HSI metric dict (sr_gae.py:489-496).
        Returns (metrics, prediction, seconds)."""
        t0 = time.perf_counter()
        pred = self.super_resolve(sr_cube, generator=generator, x_init=x_init,
                                  noise_seq=noise_seq)
        if pred.is_cuda:
            torch.cuda.synchronize(pred.device)
        dt = time.perf_counter() - t0

        metrics_list = []
        preds = pred.cpu().numpy()
        hrs = np.asarray(hr_cube)
        for y, gt in zip(preds, hrs):
            if use_color_correction:
                y = _color_correction(gt, y, num_channels=self.n_colors)
            if on_device:
                m = quality_assessment_torch(
                    torch.as_tensor(gt, device=self.device),
                    torch.as_tensor(y, device=self.device), data_range=1.0, ratio=ratio)
                m = {k: float(v) for k, v in m.items()}
            else:
                m = quality_assessment(gt, y, data_range=1.0, ratio=ratio)
            metrics_list.append(m)
        avg = {k: float(np.mean([m[k] for m in metrics_list])) for k in metrics_list[0]}
        return avg, preds, dt
