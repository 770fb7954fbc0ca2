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
  * ``super_resolve_spatial``: the same inference for one cube over a
    ('data', 'space') mesh of ranks (``parallel/``), for latency: band
    groups ride 'data', the latent's height rides 'space', and the fused
    UNet runs on H-shards with halo rows and the whole image's moments.
  * ``super_resolve_tiled``: a scene larger than one shot, as overlapping
    tiles each super-resolved alone and averaged where they overlap (the
    online replacement of the reference's offline corner and centre
    crops, ``data/crop.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .data.imresize import make_imresize_torch
from .device import resolve_device
from .diffusion.gaussian import split_generator
from .io.convert_torch import load_state_dict
from .models.gae import GAE
from .models.networks import init_weights
from .parallel.mesh import gather
from .parallel.spatial import gather_rows
from .train.ddpm_model import DDPMModel
from .utils.profiling import span, traced


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

    @traced("gae.encode")
    @torch.inference_mode()
    def encode(self, cube):
        """(B, H, W, C) cube -> (B, G, h, w, 3) latents."""
        return self._encode(cube)

    @traced("gae.decode")
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

    @traced("train.step")
    def train_step_from_hr(self, hr, scale=4, generator=None, per_group=False):
        """Training step from HR crops only; SR derived on the device."""
        hr = self._to_f32(hr)
        with torch.no_grad(), span("train.degrade"):
            sr = self._degrade_fn((hr.shape[1], hr.shape[2]), scale)(hr)
        return self.train_step({"HR": hr, "SR": sr}, generator=generator, per_group=per_group)

    def train_step(self, batch, generator=None, per_group=False):
        """One diffusion update from a cube batch {'HR','SR'} (NHWC). The
        GAE stays frozen; its latents are made under no_grad (not in
        inference mode, whose tensors autograd cannot save)."""
        with torch.no_grad(), span("train.encode"):
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

    @traced("sr.cube")
    def super_resolve(self, sr_cube, generator=None, x_init=None, noise_seq=None):
        """Full DMGASR inference on bicubic-upsampled LR cubes (B, H, W, C)
        in [0, 1]. ``x_init``/``noise_seq`` (folded latent shape) replay
        given noise through the chain."""
        b = sr_cube.shape[0]
        cond = self._fold(self.encode(sr_cube))
        z_out = self._unfold(self.ddpm.super_resolution(
            cond, generator=generator, x_init=x_init, noise_seq=noise_seq), b)
        return self.decode(z_out).clamp(0.0, 1.0)

    @torch.inference_mode()
    def super_resolve_spatial(self, sr_cube, mesh, generator=None, fused=True,
                              replay_noise=False, x_init=None, noise_seq=None):
        """``super_resolve`` of one cube over a ('data', 'space') mesh of
        ranks (``parallel.mesh.dmgasr_mesh``), for latency. Every rank of the
        mesh calls it with the same cube, and every rank returns the whole
        super-resolved cube (B, H, W, C) in [0, 1].

        The GAE encodes and decodes the whole cube on every rank. The
        (B*G) condition is wrap-padded to a multiple of n_data, and each
        rank runs the ancestral chain on its block of it:
          * ``fused=True``: its ('data', 'space') block, through the fused
            UNet on H-shards (``models/unet.py``'s ``spatial``), whatever
            ``fuse_blocks`` says; the latent's height must divide over
            'space' down to the smallest level;
          * ``fused=False``: its band groups, the whole image, through the
            model's own chain (the UNet as configured).
        Then the chains are gathered over 'space' and 'data' and unpadded.

        Noise: with ``replay_noise`` (and always with ``fused=False``)
        x_init and the noise of every step are drawn from ``generator`` as
        ``super_resolve`` draws them and then cut to the rank's block, so
        the result is the single-device one; ``x_init``/``noise_seq`` (the
        folded, unpadded latent shape, as for ``super_resolve``) replay
        given noise instead. Otherwise each rank draws its block's noise
        from its own generator, seeded from (seed, space index, data index),
        the seed drawn from ``generator`` (which must then be in the same
        state on every rank)."""
        sampler, _, t_start = self.ddpm._sampler()
        if sampler != "ancestral":
            raise ValueError(f"super_resolve_spatial runs the ancestral chain, "
                             f"not model.diffusion.sampler {sampler!r}")
        g = generator if generator is not None else self.ddpm.generator
        b = sr_cube.shape[0]
        cond = self._fold(self._encode(sr_cube))
        n, h = cond.shape[0], cond.shape[1]
        if fused and h % mesh.n_space:
            raise ValueError(f"latent height {h} does not divide over {mesh.n_space} ranks")
        padded = torch.arange(n + (-n) % mesh.n_data, device=cond.device) % n
        per = padded.numel() // mesh.n_data
        groups = padded[mesh.data_idx * per:(mesh.data_idx + 1) * per]
        hl = h // mesh.n_space if fused else h
        r0 = mesh.space_idx * hl if fused else 0

        def block(t, dim=0):  # this rank's groups (on dim) and rows (on dim + 1)
            return t.index_select(dim, groups).narrow(dim + 1, r0, hl).contiguous()

        if x_init is None and (replay_noise or not fused):
            x_init, noise_seq = self.ddpm.chain_draws(g, cond)
        d = self.ddpm.val_diffusion
        cond_b = block(cond)
        if x_init is not None:
            x_init = block(torch.as_tensor(x_init, dtype=torch.float32, device=self.device))
            noise_seq = block(torch.as_tensor(noise_seq, dtype=torch.float32,
                                              device=self.device), dim=1)
        if not fused:
            z = self.ddpm.super_resolution(cond_b, x_init=x_init, noise_seq=noise_seq)
        else:
            rank_g = None
            if x_init is None:
                seed = int(torch.randint(2 ** 62, (), generator=g, device=g.device))
                mixed = np.random.SeedSequence([seed, mesh.space_idx, mesh.data_idx])
                rank_g = torch.Generator(device=self.device).manual_seed(
                    int(mixed.generate_state(1, np.uint64)[0]))
            unet = self.ddpm.eval_unet
            with unet.fusing():
                z = d.sample_loop(lambda x, t: unet(x, t, spatial=mesh), cond=cond_b,
                                  x_init=x_init, noise_seq=noise_seq, t_start=t_start,
                                  generator=rank_g)
            z = gather_rows(z, mesh, "output")
        z = gather(z, mesh, "data", 0, "output")[:n]
        return self.decode(self._unfold(z, b)).clamp(0.0, 1.0)

    @torch.inference_mode()
    def super_resolve_tiled(self, sr_cube, tile=512, overlap=32, generator=None):
        """``super_resolve`` of a scene (H, W, C), or (1, H, W, C), larger
        than one shot: tiles of ``tile``^2 at a stride of tile - overlap,
        the last tile of each axis moved back to end on the scene's edge,
        each super-resolved alone and the overlaps averaged on the device
        (by the count of tiles covering each pixel). A scene no larger than
        one tile is one ``super_resolve``; a tile is shorter than ``tile``
        where the scene is. Returns (H, W, C) in [0, 1].

        Tile k (row-major over the origins) draws from the k-th of
        ``split_generator``'s generators of ``generator`` (the JAX package
        splits one key per tile)."""
        x = torch.as_tensor(sr_cube, dtype=torch.float32, device=self.device)
        if x.ndim == 4:
            if x.shape[0] != 1:
                raise ValueError(f"super_resolve_tiled takes one scene, got {x.shape[0]}")
            x = x[0]
        H, W, C = x.shape
        g = generator if generator is not None else self.ddpm.generator
        stride = tile - overlap

        def origins(dim):
            # clamped to >= 0, so a dim <= tile gives the one origin 0 (the
            # slice then ends at the scene's edge); a negative origin would
            # leave pixels no tile covers
            return sorted({max(0, min(o, dim - tile))
                           for o in range(0, max(dim - overlap, 1), stride)})

        single = H <= tile and W <= tile
        ys, xs = ([0], [0]) if single else (origins(H), origins(W))
        if single:  # one shot, drawing from the generator itself, as the JAX package's key
            return self.super_resolve(x[None], generator=g)[0]
        out = torch.zeros((H, W, C), dtype=torch.float32, device=self.device)
        count = torch.zeros((H, W, 1), dtype=torch.float32, device=self.device)
        tiles = [(y0, x0) for y0 in ys for x0 in xs]
        for (y0, x0), gk in zip(tiles, split_generator(g, len(tiles))):
            pred = self.super_resolve(x[y0:y0 + tile, x0:x0 + tile][None], generator=gk)[0]
            out[y0:y0 + tile, x0:x0 + tile] += pred
            count[y0:y0 + tile, x0:x0 + tile] += 1.0
        if not bool((count > 0).all()):
            raise AssertionError("tiling left pixels no tile covers")
        return out / count

    def reconstruct(self, cube):
        """GAE round trip (no diffusion): the stage-1 quality check."""
        return self.decode(self.encode(cube)).clamp(0.0, 1.0)

    # -------------------------------------------------------------- eval

    def evaluate(self, sr_cube, hr_cube, ratio=4, use_color_correction=False,
                 on_device=True, generator=None, x_init=None, noise_seq=None):
        """Super-resolve + HSI metric dict (sr_gae.py:489-496).
        Returns (metrics, prediction, seconds)."""
        # imported here: the metrics pull in scipy, which the inference
        # ranks of super_resolve_spatial need not load
        from .evalhsi.metrics import color_correction, quality_assessment
        from .evalhsi.torch_metrics import quality_assessment_torch

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
                y = color_correction(gt, y, num_channels=self.n_colors)
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
