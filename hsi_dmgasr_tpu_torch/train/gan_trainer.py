"""RaGAN trainer of the 3-D attention GAN (reference GAE/train.py:84-199):
a port of ``hsi_dmgasr_tpu/train/gan_trainer.py``.

Alternating Adam steps, the discriminator's first: D in train mode on the
generator's output (no gradient into G), then on the HR cube, its
BatchNorm running statistics moved by both passes in that order, the
relativistic-average D loss; then G against the updated D, in eval mode
and with no gradient into D's parameters, on L1 + 1e-2 SAM + 1e-3 RaGAN.
Checkpoints are the port's own: a directory holding ``gan3d.pt`` with
both nets' state_dicts (D's running statistics included).
"""

from __future__ import annotations

import os

import torch

from ..device import resolve_device
from ..models.baselines.gan3d import (
    Discriminator,
    Generator,
    ragan_d_loss,
    ragan_g_loss,
    spe_loss_gan,
)

_CKPT_FILE = "gan3d.pt"


class GAN3DTrainer:
    def __init__(self, n_bands=31, lr_g=1e-4, lr_d=1e-4, l1_weight=1.0, spe_weight=1e-2,
                 adv_weight=1e-3, seed=0, device=None):
        """Both nets are built with torch's default init under
        ``torch.manual_seed(seed)``; ``device`` defaults to CUDA and raises
        without it (``device="cpu"`` runs on the CPU)."""
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.G, self.D = Generator(n_bands), Discriminator()
        self.G.to(self.device)
        self.D.to(self.device)
        self.l1_weight, self.spe_weight, self.adv_weight = l1_weight, spe_weight, adv_weight
        self.opt_g = torch.optim.Adam(self.G.parameters(), lr=lr_g, betas=(0.9, 0.999), eps=1e-8)
        self.opt_d = torch.optim.Adam(self.D.parameters(), lr=lr_d, betas=(0.9, 0.999), eps=1e-8)

    def _to(self, x):
        return torch.as_tensor(x, device=self.device, dtype=next(self.G.parameters()).dtype)

    def d_step(self, lr_cube, hr):
        """One discriminator step (the JAX ``_d_step``); returns its loss."""
        lr_cube, hr = self._to(lr_cube), self._to(hr)
        with torch.no_grad():
            fake = self.G(lr_cube)
        self.D.train()
        self.opt_d.zero_grad(set_to_none=True)
        d_fake = self.D(fake)
        loss = ragan_d_loss(self.D(hr), d_fake)
        loss.backward()
        self.opt_d.step()
        return loss.detach()

    def g_step(self, lr_cube, hr):
        """One generator step against the current D (the JAX ``_g_step``);
        returns its loss."""
        lr_cube, hr = self._to(lr_cube), self._to(hr)
        self.D.eval().requires_grad_(False)
        try:
            self.opt_g.zero_grad(set_to_none=True)
            fake = self.G(lr_cube)
            adv = ragan_g_loss(self.D(hr), self.D(fake))
            loss = (self.l1_weight * (fake - hr).abs().mean()
                    + self.spe_weight * spe_loss_gan(fake, hr) + self.adv_weight * adv)
            loss.backward()
        finally:
            self.D.requires_grad_(True)
        self.opt_g.step()
        return loss.detach()

    def train_step(self, lr_cube, hr):
        """The D step, then the G step; returns (g_loss, d_loss)."""
        d_loss = self.d_step(lr_cube, hr)
        return self.g_step(lr_cube, hr), d_loss

    @torch.no_grad()
    def generate(self, lr_cube):
        return self.G(self._to(lr_cube))

    def save(self, path):
        """Write both nets into the directory ``path`` (made if missing)."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, _CKPT_FILE)
        cpu = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}  # noqa: E731
        torch.save({"G": cpu(self.G), "D": cpu(self.D)}, target + ".tmp")
        os.replace(target + ".tmp", target)

    def load(self, path):
        ckpt = torch.load(os.path.join(path, _CKPT_FILE), map_location="cpu", weights_only=True)
        self.G.load_state_dict(ckpt["G"])
        self.D.load_state_dict(ckpt["D"])
