"""DDPM model wrapper, inference half (reference model/model.py:61-70).

Port of the sampling side of ``hsi_dmgasr_tpu/train/ddpm_model.py``:
the UNet and the VAL diffusion built from the config, ``eval_params``,
``super_resolution`` honouring ``model.diffusion.t_start``, and the
``path.resume_state`` dispatch of ``load_resume``. The optimizer, EMA
and orbax checkpoints are not ported yet.
"""

from __future__ import annotations

import os

import torch

from ..device import resolve_device
from ..io.convert_torch import load_jax_params, load_state_dict, unflatten_npz
from ..models.networks import define_G, diffusion_for_phase, init_weights

# the reference loader drops the first and last convs (model/model.py:185-192),
# so a checkpoint with other channel counts still loads
_TORCH_RESUME_DROP = ("denoise_fn.downs.0.weight",
                      "denoise_fn.final_conv.block.3.weight",
                      "denoise_fn.final_conv.block.3.bias")


class DDPMModel:
    def __init__(self, opt, seed=0, device=None):
        """``device`` defaults to CUDA and raises without it; pass
        ``device="cpu"`` to run on the CPU. Seeded random weights unless
        ``path.resume_state`` names trained ones."""
        self.opt = opt
        self.device = resolve_device(device)
        self.unet, _ = define_G(opt)
        self.val_diffusion = diffusion_for_phase(opt, "val")
        init_weights(self.unet, torch.Generator().manual_seed(seed))
        resume = (opt.get("path") or {}).get("resume_state")
        if resume:
            self.load_resume(resume)
        self.unet.to(self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 17)

    def load_resume(self, resume):
        """The JAX package's dispatch: an ``export_params_npz`` ``.npz``,
        or a reference ``{resume}_gen.pth``. Its orbax directories are not
        read here: export them with ``export_params_npz``."""
        if os.path.isdir(resume):
            raise ValueError(
                f"resume_state {resume} is an orbax checkpoint directory, which the "
                "port does not read; export its eval weights with the JAX package's "
                "DDPMModel.export_params_npz and point resume_state at the .npz")
        if resume.endswith(".npz") and os.path.exists(resume):
            load_jax_params(self.unet, unflatten_npz(resume))
        elif os.path.exists(f"{resume}_gen.pth"):
            self.load_torch_resume(resume)
        else:
            raise FileNotFoundError(f"resume_state not found: {resume}")

    def load_torch_resume(self, prefix):
        """A reference ``{prefix}_gen.pth`` state_dict, with the first and
        last conv weights dropped and every leaf of another shape left as
        the module has it (the JAX package's ``load_torch_resume``)."""
        sd = torch.load(f"{prefix}_gen.pth", map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items() if k not in _TORCH_RESUME_DROP}
        with torch.no_grad():
            load_state_dict(self.unet, sd, strict=False)

    @property
    def eval_params(self):
        """The weights used at eval (no EMA yet: the live ones)."""
        return self.unet.state_dict()

    def _denoise(self, x, noise_level):
        return self.unet(x, noise_level)

    def super_resolution(self, cond, generator=None, x_init=None, noise_seq=None):
        """Reverse-diffuse conditioned on the upsampled LR latent (NHWC).
        ``x_init``/``noise_seq`` replay given noise instead of drawing."""
        diff_opt = self.opt["model"]["diffusion"] or {}
        sampler = diff_opt.get("sampler") or "ancestral"
        if sampler != "ancestral":
            raise NotImplementedError(f"sampler {sampler!r} is not ported yet")
        with torch.inference_mode():
            cond = torch.as_tensor(cond, dtype=torch.float32, device=self.device)
            return self.val_diffusion.sample_loop(
                self._denoise, cond=cond, x_init=x_init, noise_seq=noise_seq,
                t_start=diff_opt.get("t_start"),
                generator=generator if generator is not None else self.generator)
