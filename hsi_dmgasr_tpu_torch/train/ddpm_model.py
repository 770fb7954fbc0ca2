"""DDPM lifecycle wrapper (reference model/model.py:12-202).

Port of ``hsi_dmgasr_tpu/train/ddpm_model.py`` for the SR3 model:

  * the UNet from the config, re-initialised orthogonally as the JAX
    package does (reference model/networks.py:110-112), the TRAIN and VAL
    diffusions side by side;
  * ``train_step``: one Adam update on a latent batch {'HR', 'SR'} (NHWC)
    through the unfused autograd UNet with dropout drawn from the step's
    generator, the lr schedule stepped, then the EMA updated (``state.py``);
  * ``eval_unet`` / ``eval_params``: the EMA weights when
    ``use_ema_for_eval`` is set; ``super_resolution`` samples with them,
    honouring ``model.diffusion.t_start``;
  * checkpoints in the port's own format (a directory ``I{it}_E{ep}``
    holding one ``state.pt``: weights, Adam, the schedule, the EMA, the
    step) and the JAX package's ``.npz`` export of the eval weights, so a
    model trained here loads into the JAX package and the reverse;
  * ``load_resume``: the port's checkpoint directory, an ``.npz`` export
    or a reference ``{prefix}_gen.pth``. The JAX package's orbax
    directories are not read: export them with ``export_params_npz``.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np
import torch

from ..device import resolve_device
from ..io.convert_torch import export_jax_params, load_jax_params, load_state_dict, unflatten_npz
from ..models.networks import define_G, diffusion_for_phase, init_weights
from .state import EMA, build_optimizer

# the reference loader drops the first and last convs (model/model.py:185-192),
# so a checkpoint with other channel counts still loads
_TORCH_RESUME_DROP = ("denoise_fn.downs.0.weight",
                      "denoise_fn.final_conv.block.3.weight",
                      "denoise_fn.final_conv.block.3.bias")
_STATE_FILE = "state.pt"


class DDPMModel:
    def __init__(self, opt, seed=0, device=None):
        """``device`` defaults to CUDA and raises without it; pass
        ``device="cpu"`` to run on the CPU. Seeded orthogonal weights
        unless ``path.resume_state`` names trained ones."""
        self.opt = opt
        self.device = resolve_device(device)
        self.unet, self.train_diffusion = define_G(opt)
        self.val_diffusion = diffusion_for_phase(opt, "val")
        init_weights(self.unet, torch.Generator().manual_seed(seed), init_type="orthogonal")
        self.unet.to(self.device).eval()
        ema_opt = (opt.get("train") or {}).get("ema_scheduler")
        self.ema_decay = ema_opt["ema_decay"] if ema_opt else None
        # made when first asked for (training, a checkpoint), so inference
        # holds no optimizer and no second copy of the weights
        self._optimizer = self._scheduler = self._ema = None
        # beyond-reference: sample from the EMA weights at eval time
        self.use_ema_for_eval = bool((ema_opt or {}).get("use_ema_for_eval"))
        self.step = 0
        self.begin_step = 0
        self.begin_epoch = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 17)
        resume = (opt.get("path") or {}).get("resume_state")
        if resume:
            self.load_resume(resume)

    # ------------------------------------------------------------ train

    def _start_optimizer(self):
        if self._optimizer is None:
            self._optimizer, self._scheduler = build_optimizer(self.unet, self.opt)

    def _start_ema(self):
        """The EMA's copy of the weights as they are now, made once (None
        without ``train.ema_scheduler``). Everything that moves the live
        weights makes it first: until then it would equal them."""
        if self._ema is None and self.ema_decay is not None:
            self._ema = EMA(self.unet, self.ema_decay)
        return self._ema

    @property
    def optimizer(self):
        """Adam over the UNet (``state.build_optimizer``)."""
        self._start_optimizer()
        return self._optimizer

    @property
    def scheduler(self):
        """The optimizer's lr schedule, a ``LambdaLR``."""
        self._start_optimizer()
        return self._scheduler

    @property
    def ema(self):
        """The ``state.EMA`` of the weights."""
        return self._start_ema()

    def compute_grads(self, batch, generator=None, gamma=None, noise=None):
        """The loss of one batch and its gradients in ``.grad``, the UNet
        in train mode with dropout drawn from ``generator``. ``gamma`` and
        ``noise`` replace the loss's draws."""
        g = self.generator if generator is None else generator
        hr = torch.as_tensor(batch["HR"], dtype=torch.float32, device=self.device)
        sr = torch.as_tensor(batch["SR"], dtype=torch.float32, device=self.device)
        self.unet.train()
        self.unet.set_dropout_generator(g)
        try:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.train_diffusion.p_losses(self.unet, hr, sr, generator=g,
                                                 gamma=gamma, noise=noise)
            loss.backward()
        finally:
            self.unet.set_dropout_generator(None)
            self.unet.eval()
        return loss.detach()

    def apply_gradients(self):
        """Adam on the gradients, the lr schedule's next value, then the EMA."""
        ema = self._start_ema()  # at the weights before the first step
        self.optimizer.step()
        self.scheduler.step()
        if ema is not None:
            ema.update(self.unet)
        self.step += 1

    def train_step(self, batch, generator=None, gamma=None, noise=None):
        """One optimizer step on a latent batch {'HR','SR'} (NHWC). Returns
        the loss as a tensor on the device (no host sync)."""
        loss = self.compute_grads(batch, generator, gamma, noise)
        self.apply_gradients()
        return loss

    # ----------------------------------------------------------- sample

    @property
    def eval_unet(self):
        """The module sampled at eval: the EMA copy when use_ema_for_eval
        (the live module while no copy was made, whose weights it equals)."""
        if self.use_ema_for_eval and self._ema is not None:
            return self._ema.module
        return self.unet

    @property
    def eval_params(self):
        """Weights used at eval: EMA when use_ema_for_eval is set."""
        return self.eval_unet.state_dict()

    def _denoise(self, x, noise_level):
        return self.eval_unet(x, noise_level)

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

    # ------------------------------------------------------- checkpoints

    def save_checkpoint(self, ckpt_dir, epoch, iter_step, name=None):
        """The whole train state in ``{ckpt_dir}/I{iter}_E{epoch}/state.pt``
        (``name`` overrides the directory name, as for best-val snapshots).
        An existing directory of that name is replaced."""
        path = os.path.abspath(os.path.join(ckpt_dir, name or f"I{iter_step}_E{epoch}"))
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save({"model": self.unet.state_dict(),
                    "ema": self.ema.state_dict() if self.ema is not None else None,
                    "optimizer": self.optimizer.state_dict(),
                    "scheduler": self.scheduler.state_dict(),
                    "step": self.step}, os.path.join(path, _STATE_FILE))
        return path

    def load_checkpoint(self, path):
        """Restore a ``save_checkpoint`` directory; the step counter resumes
        from its ``(best_)I{it}_E{ep}`` name."""
        # on the CPU: Adam keeps its step counts there, and load_state_dict
        # moves the rest to the parameters' device
        state = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                           weights_only=True)
        self.unet.load_state_dict(state["model"])
        if self.ema is not None:
            if state["ema"] is None:
                raise ValueError(f"{path} holds no EMA, but the config asks for one")
            self.ema.load_state_dict(state["ema"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = state["step"]
        m = re.fullmatch(r"(?:best_)?I(\d+)_E(\d+)", os.path.basename(path.rstrip("/")))
        if m:
            self.begin_step = int(m.group(1))
            self.begin_epoch = int(m.group(2))

    def load_torch_resume(self, prefix):
        """A reference ``{prefix}_gen.pth`` state_dict into the live
        weights, with the first and last conv weights dropped and every
        leaf of another shape left as the module has it (the JAX package's
        ``load_torch_resume``, which leaves the EMA as it was)."""
        sd = torch.load(f"{prefix}_gen.pth", map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items() if k not in _TORCH_RESUME_DROP}
        self._start_ema()  # the EMA keeps the weights from before the load
        with torch.no_grad():
            load_state_dict(self.unet, sd, strict=False)
        self.begin_step = 0
        self.begin_epoch = 0

    def export_params_npz(self, path, dtype=np.float16):
        """The EVAL weights as the JAX package's ``export_params_npz`` writes
        them: flattened flax paths ``params/...``, float16 by default."""
        arrays = {"params/" + "/".join(p): v.astype(dtype)
                  for p, v in export_jax_params(self.eval_unet).items()}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **arrays)
        return path

    def load_params_npz(self, path):
        """An ``export_params_npz`` file (of either package) into both the
        live and the EMA weights: it holds the eval weights, which eval
        must see whatever use_ema_for_eval says."""
        load_jax_params(self.unet, unflatten_npz(path))
        if self._ema is not None:
            self._ema.load_state_dict(self.unet.state_dict())

    def load_resume(self, resume):
        """The JAX package's dispatch: a checkpoint directory (the port's
        ``state.pt``), an ``export_params_npz`` ``.npz``, or a reference
        ``{resume}_gen.pth``."""
        if os.path.isdir(resume):
            if not os.path.exists(os.path.join(resume, _STATE_FILE)):
                raise ValueError(
                    f"resume_state {resume} is not a checkpoint of the port (no {_STATE_FILE}); "
                    "an orbax checkpoint directory of the JAX package is not read here: export "
                    "its eval weights with the JAX package's DDPMModel.export_params_npz and "
                    "point resume_state at the .npz")
            self.load_checkpoint(resume)
        elif resume.endswith(".npz") and os.path.exists(resume):
            self.load_params_npz(resume)
        elif os.path.exists(f"{resume}_gen.pth"):
            self.load_torch_resume(resume)
        else:
            raise FileNotFoundError(f"resume_state not found: {resume}")
