"""DDPM lifecycle wrapper (reference model/model.py:12-202).

Port of ``hsi_dmgasr_tpu/train/ddpm_model.py`` for both models of
``which_model_G`` ('sr3', and 'ddpm': discrete t and BatchNorm):

  * the UNet from the config, re-initialised orthogonally as the JAX
    package does (reference model/networks.py:110-112), the TRAIN and VAL
    diffusions side by side;
  * ``train_step``: one Adam update on a latent batch {'HR', 'SR'} (NHWC;
    'SR' None for an unconditional model) through the unfused autograd
    UNet with dropout drawn from the step's generator (BatchNorm running
    statistics move, once a step), the lr schedule stepped, then the EMA
    updated (``state.py``);
  * ``eval_unet`` / ``eval_params``: the EMA weights when
    ``use_ema_for_eval`` is set (with the live running statistics);
    ``super_resolution`` and ``sample`` (an unconditional model) sample
    with them, through the sampler of ``model.diffusion.sampler``
    ("ancestral", honouring ``t_start``, or "ddim" with ``ddim_steps``),
    over batch chunks of ``latent_chunk`` latents where the JAX package's
    rule lets it count, or with ``continous`` return the reference's
    reverse-process stack;
  * checkpoints in the port's own format (a directory ``I{it}_E{ep}``
    holding one ``state.pt``: weights, Adam, the schedule, the EMA, the
    step) and the JAX package's ``.npz`` export of the eval weights, so a
    model trained here loads into the JAX package and the reverse;
  * ``load_resume``: the port's checkpoint directory, an ``.npz`` export
    or a reference ``{prefix}_gen.pth``. The JAX package's orbax
    directories are not read: export them with ``export_params_npz``;
  * data parallelism over a 'data' mesh of ranks (``parallel/mesh.py``),
    picked as the JAX package picks its mesh: ``n_devices`` (or the
    length of ``gpu_ids``), capped at the ranks of the process group.
    The weights are broadcast from the first rank. ``train_step`` takes
    the global batch: every rank draws the global batch's gamma (or t),
    noise and dropout masks from the same generator and cuts its rows,
    so the step is the single process's step; the gradients are
    averaged by sample count (``parallel/data_parallel.py``), and a
    BatchNorm UNet takes the global batch's moments. ``super_resolution``
    and ``sample`` draw the chain's x_init and noise for the whole batch,
    wrap-pad it to a multiple of the mesh, run this rank's rows and
    gather them in rank order (``continous`` runs the whole batch on
    every rank). ``latent_chunk`` is off under a mesh of more than 1.
"""

from __future__ import annotations

import os
import re
import shutil

import numpy as np
import torch

from ..device import resolve_device
from ..diffusion.gaussian import split_generator
from ..io.convert_torch import export_jax_params, load_jax_params, load_state_dict, unflatten_npz
from ..models.networks import define_G, diffusion_for_phase, init_weights
from ..parallel import data_parallel as dp
from ..parallel.mesh import data_parallel_mesh, gather, local_rows, replicate
from ..parallel.multihost import get_world_size
from ..utils.profiling import traced
from .state import EMA, build_optimizer

# the reference loader drops the first and last convs (model/model.py:185-192),
# so a checkpoint with other channel counts still loads
_TORCH_RESUME_DROP = ("denoise_fn.downs.0.weight",
                      "denoise_fn.final_conv.block.3.weight",
                      "denoise_fn.final_conv.block.3.bias")
_STATE_FILE = "state.pt"


class DDPMModel:
    def __init__(self, opt, mesh=None, seed=0, device=None):
        """``device`` defaults to CUDA and raises without it (or to the
        mesh's device); pass ``device="cpu"`` to run on the CPU. ``mesh``
        (a 'data' mesh) defaults to the JAX package's rule: ``n_devices``
        ranks, capped at the process group. Seeded orthogonal weights
        unless ``path.resume_state`` names trained ones."""
        self.opt = opt
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        if mesh is None:
            n_dev = opt.get("n_devices") or len(opt.get("gpu_ids") or [0])
            mesh = data_parallel_mesh(min(n_dev, get_world_size()), device=self.device)
        self.mesh = mesh
        if mesh.n_data > 1:
            self.device = mesh.device
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
        self.log_dict = {}
        resume = (opt.get("path") or {}).get("resume_state")
        if resume:
            self.load_resume(resume)
        dp.sync_batchnorm(self.unet, mesh)
        replicate(mesh, self.unet)

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

    @property
    def discrete(self):
        """The 'ddpm' model: the UNet is fed the integer timestep."""
        return self.unet.time_embedding == "discrete"

    @traced("train.grads")
    def compute_grads(self, batch, generator=None, gamma=None, noise=None, t=None):
        """The loss of one batch and its gradients in ``.grad``, the UNet
        in train mode with dropout drawn from ``generator`` (BatchNorm
        running statistics move). ``gamma`` (the 'sr3' model) or ``t`` (the
        'ddpm' model), and ``noise``, replace the loss's draws."""
        if (gamma if self.discrete else t) is not None:
            raise ValueError("gamma replays the 'sr3' loss's draw, t the 'ddpm' loss's")
        draws = {"t": t} if self.discrete else {"gamma": gamma}
        g = self.generator if generator is None else generator
        hr = torch.as_tensor(batch["HR"], dtype=torch.float32, device=self.device)
        sr = batch.get("SR")
        if sr is not None:
            sr = torch.as_tensor(sr, dtype=torch.float32, device=self.device)
        # the global batch's draws, then this rank's rows of everything (all
        # rows on a mesh of 1)
        n = hr.shape[0]
        draws = self.train_diffusion.loss_draws(hr.shape, hr.dtype, self.device, g,
                                                noise=noise, **draws)
        start, stop = local_rows(n, self.mesh)
        draws = {k: v[start:stop] for k, v in draws.items()}
        hr = hr[start:stop]
        sr = None if sr is None else sr[start:stop]
        self.unet.train()
        self.unet.set_dropout_generator(g, (n, start, stop))
        try:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.train_diffusion.p_losses(self.unet, hr, sr, generator=g, **draws)
            loss = dp.backward(loss, self.unet.parameters(), self.mesh, n)
        finally:
            self.unet.set_dropout_generator(None)
            self.unet.eval()
        return loss

    @traced("train.update")
    def apply_gradients(self):
        """Adam on the gradients, the lr schedule's next value, then the EMA."""
        ema = self._start_ema()  # at the weights before the first step
        self.optimizer.step()
        self.scheduler.step()
        if ema is not None:
            ema.update(self.unet)
        self.step += 1

    def train_step(self, batch, generator=None, gamma=None, noise=None, t=None):
        """One optimizer step on a latent batch {'HR','SR'} (NHWC). Returns
        the loss as a tensor on the device (no host sync)."""
        loss = self.compute_grads(batch, generator, gamma, noise, t)
        self.apply_gradients()
        self.log_dict["l_pix"] = loss
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

    def _sampler(self, unconditional=False):
        """(sampler, ddim_steps, t_start) of ``model.diffusion``, with the
        JAX package's refusal of ``t_start`` outside conditional ancestral
        sampling. ``latent_chunk`` is read by ``_latent_chunk``."""
        diff_opt = self.opt["model"]["diffusion"] or {}
        sampler = diff_opt.get("sampler") or "ancestral"
        if sampler not in ("ancestral", "ddim"):
            raise ValueError(f"model.diffusion.sampler {sampler!r}: 'ancestral' or 'ddim'")
        t_start = diff_opt.get("t_start")
        if t_start is not None and (unconditional or sampler == "ddim"):
            raise ValueError("t_start requires conditional ancestral sampling")
        return sampler, diff_opt.get("ddim_steps"), t_start

    def _latent_chunk(self, n, unconditional=False, continous=False):
        """The chunk of ``model.diffusion.latent_chunk`` a chain of ``n``
        latents runs over, or 0 for one chain over the whole batch. As in
        the JAX package (``train/ddpm_model.py:_get_sampler``) it counts
        only for a conditional chain that is not ``continous``, over a
        batch larger than the chunk and divisible by it, and not under a
        data mesh of more than one rank (whose rows are already cut)."""
        chunk = int((self.opt["model"]["diffusion"] or {}).get("latent_chunk") or 0)
        if (unconditional or continous or self.mesh.n_data > 1
                or not (chunk and n > chunk and n % chunk == 0)):
            return 0
        return chunk

    @traced("sampler.chain")
    @torch.inference_mode()
    def _run_chain(self, generator, cond=None, shape=None, x_init=None, noise_seq=None,
                   continous=False):
        """One chain of the configured sampler, from ``cond`` or, without
        it, from pure noise of ``shape``. ``continous`` runs the ancestral
        chain whatever the sampler (as the JAX package does), its x_init
        drawn first from the chain's own generator, and returns the
        reverse-process stack.

        Under ``latent_chunk`` the chunks run one after another into one
        output, chunk k drawing from the k-th of ``split_generator``'s
        generators (the JAX package splits one key per chunk); replayed
        ``x_init`` (B, ...) and ``noise_seq`` (steps, B, ...) are cut to
        the chunk along the batch axis, so a chunked chain from given
        draws is the unchunked chain from the same draws."""
        sampler, ddim_steps, t_start = self._sampler(unconditional=cond is None)
        g = generator if generator is not None else self.generator
        d = self.val_diffusion
        if continous:
            if x_init is None:
                x_init = (d.init_from_cond(cond, int(t_start), g) if t_start is not None else
                          torch.randn(tuple(shape) if cond is None else cond.shape, generator=g,
                                      dtype=torch.float32, device=self.device))
            x_init = torch.as_tensor(x_init, dtype=torch.float32, device=self.device)
            _, states = d.sample_loop(self._denoise, cond=cond, x_init=x_init,
                                      noise_seq=noise_seq, t_start=t_start, generator=g,
                                      return_intermediates=True)
            return self._process_stack(x_init if cond is None else cond, states)

        def chain(g, cond, x_init, noise_seq):
            if sampler == "ddim":
                return d.ddim_sample_loop(self._denoise, shape=shape, cond=cond,
                                          steps=ddim_steps, x_init=x_init, noise_seq=noise_seq,
                                          generator=g)
            return d.sample_loop(self._denoise, cond=cond, shape=shape, x_init=x_init,
                                 noise_seq=noise_seq, t_start=t_start, generator=g)

        n = cond.shape[0] if cond is not None else shape[0]
        chunk = self._latent_chunk(n, unconditional=cond is None)
        if not chunk:
            return chain(g, cond, x_init, noise_seq)
        # one output written chunk by chunk: a list concatenated at the end
        # would hold every chunk twice at the peak
        out = torch.empty(cond.shape, dtype=torch.float32, device=cond.device)
        for i, gi in enumerate(split_generator(g, n // chunk)):
            part = slice(i * chunk, (i + 1) * chunk)
            out[part] = chain(gi, cond[part], None if x_init is None else x_init[part],
                              None if noise_seq is None else noise_seq[:, part])
        return out

    def chain_draws(self, generator, cond=None, shape=None, x_init=None, noise=True):
        """x_init and the noise of every step of the configured chain over
        ``cond`` (or pure noise of ``shape``), drawn from ``generator`` as
        the chain draws them, in its order: (x_init, noise_seq), the
        ancestral noise_seq (t0, B, ...) ending on the zeros of the last
        step, None for DDIM (eta 0 draws no noise) or without ``noise``. A
        given ``x_init`` is kept, and not drawn."""
        sampler, _, t_start = self._sampler(unconditional=cond is None)
        d = self.val_diffusion
        shape = tuple(cond.shape) if cond is not None else tuple(shape)

        def randn():
            return torch.randn(shape, generator=generator, dtype=torch.float32,
                               device=self.device)

        t0 = d.schedule.num_timesteps if t_start is None else int(t_start)
        if x_init is not None:
            x_init = torch.as_tensor(x_init, dtype=torch.float32, device=self.device)
        elif sampler == "ddim" or t_start is None:
            x_init = randn()
        else:
            x_init = d.init_from_cond(cond, t0, generator)
        if sampler == "ddim" or not noise:
            return x_init, None
        steps = [randn() for _ in range(t0 - 1)] + [torch.zeros_like(x_init)]
        return x_init, torch.stack(steps)

    @torch.inference_mode()
    def _sharded_chain(self, generator, cond=None, shape=None, x_init=None, noise_seq=None):
        """The chain over a 'data' mesh: the whole batch's draws (given, or
        drawn as one process draws them), the batch wrap-padded to a
        multiple of the mesh (the JAX package's ``mode='wrap'``), this
        rank's rows run, the rows gathered in rank order and cropped."""
        g = generator if generator is not None else self.generator
        b = cond.shape[0] if cond is not None else shape[0]
        if x_init is None or noise_seq is None:
            x_init, drawn = self.chain_draws(g, cond, shape, x_init, noise=noise_seq is None)
            noise_seq = drawn if noise_seq is None else noise_seq
        x_init = torch.as_tensor(x_init, dtype=torch.float32, device=self.device)
        if noise_seq is not None:
            noise_seq = torch.as_tensor(noise_seq, dtype=torch.float32, device=self.device)
        n = self.mesh.n_data
        wrap = torch.arange(b + (-b) % n, device=self.device) % b
        start, stop = local_rows(wrap.numel(), self.mesh)
        mine = wrap[start:stop]
        out = self._run_chain(
            g, cond=None if cond is None else cond[mine],
            shape=None if shape is None else (stop - start, *shape[1:]), x_init=x_init[mine],
            noise_seq=None if noise_seq is None else noise_seq[:, mine])
        return gather(out, self.mesh, "data", 0, "latents")[:b]

    @staticmethod
    def _process_stack(start, states):
        """The reference's continous stack (diffusion.py:177-201): the start
        image (the conditioning when conditional, the initial noise when
        not), then the state after every ``1 | (T // 10)``-strided step
        (counted down from T - 1), concatenated along the batch axis."""
        n = states.shape[0]
        stride = 1 | (n // 10)
        keep = [i for i, t in enumerate(range(n - 1, -1, -1)) if t % stride == 0]
        return torch.cat([start.float()] + [states[i] for i in keep], 0)

    def super_resolution(self, cond, generator=None, x_init=None, noise_seq=None,
                         continous=False):
        """Reverse-diffuse conditioned on the upsampled LR latent (NHWC)
        (model/model.py:61-70 test()). ``x_init``/``noise_seq`` replay given
        noise instead of drawing (``noise_seq`` holds one noise per step of
        the configured chain). ``continous=True`` returns the reference's
        reverse-process stack instead of the final state."""
        with torch.inference_mode():
            cond = torch.as_tensor(cond, dtype=torch.float32, device=self.device)
        if self.mesh.n_data > 1 and not continous:
            return self._sharded_chain(generator, cond=cond, x_init=x_init, noise_seq=noise_seq)
        return self._run_chain(generator, cond=cond, x_init=x_init, noise_seq=noise_seq,
                               continous=continous)

    def sample(self, batch_size=1, generator=None, continous=False, x_init=None, noise_seq=None):
        """Unconditional generation (model/model.py:72-79) of ``batch_size``
        images of image_size^2 x channels. ``continous=True`` returns the
        process stack seeded from the initial noise (diffusion.py:182-188)."""
        if self.opt["model"]["diffusion"].get("conditional", True):
            raise ValueError(
                "sample() needs an unconditional config (model.diffusion.conditional=false, "
                "unet.in_channel == diffusion.channels); this config is conditional: use "
                "super_resolution() instead")
        diff_opt = self.opt["model"]["diffusion"]
        shape = (batch_size, diff_opt["image_size"], diff_opt["image_size"], diff_opt["channels"])
        if self.mesh.n_data > 1 and not continous:
            return self._sharded_chain(generator, shape=shape, x_init=x_init, noise_seq=noise_seq)
        return self._run_chain(generator, shape=shape, x_init=x_init, noise_seq=noise_seq,
                               continous=continous)

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
        """The EVAL weights (and the BatchNorm running statistics) as the
        JAX package's ``export_params_npz`` writes them: flattened flax paths
        ``params/...`` (``batch_stats/...``), float16 by default."""
        arrays = {f"{c}/" + "/".join(p): v.astype(dtype)
                  for c in ("params", "batch_stats")
                  for p, v in export_jax_params(self.eval_unet, c).items()}
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

    # ------------------------------------------------------------- misc

    def get_current_log(self):
        """The last step's logged scalars as floats (``l_pix``: its loss)."""
        return {k: float(v) for k, v in self.log_dict.items()}

    @property
    def n_params(self):
        """The UNet's parameter count."""
        return sum(p.numel() for p in self.unet.parameters())
