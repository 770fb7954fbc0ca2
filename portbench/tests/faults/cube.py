"""Faults planted underneath a ``cube`` cell's timed path, each of which
the correctness check has to read as ``correct`` false: an output cube
altered where it is produced, half of the UNet's batch left out (the other
half copied), and a chain step that returns its state unchanged. Each
takes pytest's ``monkeypatch``."""

from __future__ import annotations

import torch


def _altered_cube(monkeypatch):
    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline

    real = DMGASRPipeline.super_resolve

    def altered(self, *a, **kw):
        out = real(self, *a, **kw).clone()
        out[0, 0, 0, 0] = 1.0 - out[0, 0, 0, 0]
        return out
    monkeypatch.setattr(DMGASRPipeline, "super_resolve", altered)


def _half_batch_unet(monkeypatch):
    from hsi_dmgasr_tpu_torch.models.unet import UNet

    real = UNet.forward

    def half(self, x, time, spatial=None):
        n = x.shape[0] // 2 or 1
        out = real(self, x[:n], time[:n], spatial)
        return out[torch.arange(x.shape[0]) % n]  # the other half copied, not computed
    monkeypatch.setattr(UNet, "forward", half)


def _chain_step_unchanged(monkeypatch):
    from hsi_dmgasr_tpu_torch.diffusion.gaussian import GaussianDiffusion

    monkeypatch.setattr(GaussianDiffusion, "_step", lambda self, fn, x, *a, **kw: x)


FAULTS = [_altered_cube, _half_batch_unet, _chain_step_unchanged]
