"""Faults planted underneath a ``train`` cell's timed path, each of which
the correctness check has to read as ``correct`` false: a step that
leaves the weights unchanged, half of the batch left out of the loss (the
mean taken over the rest), and the loss altered where it is produced.
Each takes pytest's ``monkeypatch``."""

from __future__ import annotations


def _train_step_unchanged(monkeypatch):
    from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

    def frozen(self):
        self._start_ema()
        self.step += 1
    monkeypatch.setattr(DDPMModel, "apply_gradients", frozen)


def _half_batch_loss(monkeypatch):
    from hsi_dmgasr_tpu_torch.diffusion.gaussian import GaussianDiffusion

    real = GaussianDiffusion._loss

    def half(self, noise, eps_pred, weight):
        n = noise.shape[0] // 2
        return real(self, noise[:n], eps_pred[:n], weight[:n])
    monkeypatch.setattr(GaussianDiffusion, "_loss", half)


def _altered_loss(monkeypatch):
    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline

    real = DMGASRPipeline.train_step_from_hr
    monkeypatch.setattr(DMGASRPipeline, "train_step_from_hr",
                        lambda self, *a, **kw: real(self, *a, **kw) * 1.01)


FAULTS = [_train_step_unchanged, _half_batch_loss, _altered_loss]
