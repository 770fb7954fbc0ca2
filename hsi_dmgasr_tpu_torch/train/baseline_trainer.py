"""Trainer of the baseline HSI-SR zoo: a port of
``hsi_dmgasr_tpu/train/baseline_trainer.py``.

Covers the reference's per-model training scripts (SSPSR.py:208-269,
GAE/{GELIN,EDSR,MCNet_train,GDRNN_train}.py): Adam, the model's loss
(HybridLoss for SSPSR, HLoss for GELIN, L1 for EDSR and MCNet,
myloss_spe for GDRRN) and optional gradient clipping by the global norm
(GDRNN_train.py:35; optax's ``clip_by_global_norm`` before Adam, here
``clip_grad_norm_``). One device: the JAX trainer's data-parallel
``mesh`` is not ported. Construction needs no example input, so GELIN,
whose JAX trainer cannot initialise (ROADMAP.md §3), trains here.
Checkpoints are the port's own: a directory holding ``baseline.pt``
with the model's state_dict and the arguments that built it.
"""

from __future__ import annotations

import os

import torch

from ..device import resolve_device
from ..models.baselines import EDSR, GDRNN, GELIN, MCNet, SSPSR
from .losses import h_loss, hybrid_loss, spe_loss

_TWO_INPUT = {"sspsr", "gelin"}  # forward(lr, lms)
_CKPT_FILE = "baseline.pt"


def build_baseline(name, n_colors, scale=4, **overrides):
    """The model ``name`` at the JAX package's defaults; EDSR keeps its x2
    pin whatever ``scale`` says, as the JAX package's does."""
    name = name.lower()
    if name == "sspsr":
        kw = dict(n_subs=8, n_ovls=2, n_colors=n_colors, n_blocks=3, n_feats=256,
                  n_scale=scale, res_scale=0.1)
        return SSPSR(**{**kw, **overrides})
    if name == "gelin":
        kw = dict(n_feats=64, n_colors=n_colors, n_subs=8, n_ovls=2, blocks=4, scale=scale)
        return GELIN(**{**kw, **overrides})
    if name == "edsr":
        kw = dict(n_resblocks=16, n_feats=64, n_colors=n_colors)
        return EDSR(**{**kw, **overrides})
    if name == "mcnet":
        kw = dict(scale=scale, n_colors=n_colors, n_feats=32)
        return MCNet(**{**kw, **overrides})
    if name == "gdrrn":
        kw = dict(input_chnl_hsi=n_colors, group=1)
        return GDRNN(**{**kw, **overrides})
    raise ValueError(f"unknown baseline {name}")


def default_loss(name):
    """The model's training loss ``(y, gt, batch) -> scalar``."""
    name = name.lower()
    if name == "sspsr":
        return lambda y, gt, b: hybrid_loss(y, gt)
    if name == "gelin":
        return lambda y, gt, b: h_loss(y, gt, 0.3, 0.1)
    if name == "gdrrn":
        return lambda y, gt, b: spe_loss(y, gt, n=b)
    return lambda y, gt, b: (y - gt).abs().mean()


class BaselineTrainer:
    def __init__(self, name, n_colors, scale=4, lr=1e-4, seed=0, grad_clip=None, loss_fn=None,
                 device=None, **overrides):
        """The model is built with torch's default init under
        ``torch.manual_seed(seed)`` (the global generator is restored
        after). ``device`` defaults to CUDA and raises without it; pass
        ``device="cpu"`` to run on the CPU."""
        self.name = name.lower()
        self.device = resolve_device(device)
        self.config = dict(name=self.name, n_colors=n_colors, scale=scale, **overrides)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.model = build_baseline(name, n_colors, scale, **overrides)
        self.model.to(self.device)
        self.two_input = self.name in _TWO_INPUT
        self.loss_fn = loss_fn or default_loss(name)
        self.grad_clip = grad_clip
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8)
        self.step = 0

    def _to(self, x):
        """A batch (numpy or tensor) on the device, in the model's dtype."""
        return torch.as_tensor(x, device=self.device,
                               dtype=next(self.model.parameters()).dtype)

    def _apply(self, lr_cube, lms):
        if self.two_input:
            return self.model(lr_cube, lms)
        return self.model(lr_cube)

    def compute_grads(self, lr_cube, hr, lms=None):
        """The loss of one batch, its gradients in ``.grad``. ``lms``
        defaults to ``lr_cube``, as in the JAX trainer."""
        self.optimizer.zero_grad(set_to_none=True)
        lr_cube, hr = self._to(lr_cube), self._to(hr)
        lms = lr_cube if lms is None else self._to(lms)
        loss = self.loss_fn(self._apply(lr_cube, lms), hr, hr.shape[0])
        loss.backward()
        return loss.detach()

    def apply_gradients(self):
        if self.grad_clip:
            torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.grad_clip)
        self.optimizer.step()
        self.step += 1

    def train_step(self, lr_cube, hr, lms=None):
        """One Adam step; returns the loss as a tensor on the device."""
        loss = self.compute_grads(lr_cube, hr, lms)
        self.apply_gradients()
        return loss

    @torch.no_grad()
    def predict(self, lr_cube, lms=None):
        lr_cube = self._to(lr_cube)
        return self._apply(lr_cube, lr_cube if lms is None else self._to(lms))

    def save(self, path):
        """Write the model's weights and arguments into the directory
        ``path`` (made if missing; a save to the same path replaces the
        last one)."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, _CKPT_FILE)
        torch.save({"state_dict": {k: v.detach().cpu() for k, v in
                                   self.model.state_dict().items()},
                    "config": dict(self.config)}, target + ".tmp")
        os.replace(target + ".tmp", target)

    def load(self, path):
        """Load the weights a ``save`` wrote into ``path``; raises when they
        were saved from another model or width."""
        ckpt = torch.load(os.path.join(path, _CKPT_FILE), map_location="cpu", weights_only=True)
        if ckpt["config"] != self.config:
            raise ValueError(f"{path} holds {ckpt['config']}, this trainer is {self.config}")
        self.model.load_state_dict(ckpt["state_dict"])
