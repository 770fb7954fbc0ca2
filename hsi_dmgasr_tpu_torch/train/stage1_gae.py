"""Stage-1 GAE trainer (reference AE.py:516-637 ``__main__``).

Port of ``hsi_dmgasr_tpu/train/stage1_gae.py``. Trains the Group
AutoEncoder on HR cubes with the GELIN HLoss(0.3, 0.1) (AE.py:613-614)
and Adam at 1e-4 (AE.py:565), no schedule. Options, as in the JAX
package:

  * ``mask_p`` and ``loss="l1"``: the AEddp masked-reconstruction recipe
    (GAE/AEddp.py:196-247): a random fraction of the cube is zeroed, and
    the autoencoder is trained to match the MASKED cube;
  * ``perceptual_fn``: the optional "VGGSAM" term (AE.py:551-604), added
    as ``perceptual_weight * perceptual_fn(recon, hr, generator, bands)``;
    ``make_vgg_perceptual_fn`` makes it from a ``models.vgg.VGG19``.

Checkpoints are the port's own: a directory holding ``gae.pt`` with the
GAE state_dict and its widths, no optimizer state (the JAX package's
orbax save holds none either). The JAX trainer's data-parallel ``mesh``
is not ported.
"""

from __future__ import annotations

import math
import os

import torch

from ..device import resolve_device
from ..io.convert_torch import load_state_dict
from ..models.gae import GAE, random_mask
from ..models.networks import init_weights
from .losses import h_loss

_CKPT_FILE = "gae.pt"


def make_vgg_perceptual_fn(vgg):
    """The reference's p_loss (AE.py:602-604): the L1 between the VGG19
    logits of 3 bands of the reconstruction and of the target. The bands
    are drawn uniformly with replacement, one draw for the whole batch,
    from ``generator``; ``bands`` replays a given draw. ``vgg`` is put in
    eval mode and frozen; it must sit on the device of the cubes."""
    vgg.eval().requires_grad_(False)

    def fn(recon, hr, generator=None, bands=None):
        if bands is None:
            bands = torch.randint(0, hr.shape[-1], (3,), generator=generator, device=hr.device)
        bands = torch.as_tensor(bands, device=hr.device)
        return (vgg(recon.index_select(-1, bands))
                - vgg(hr.index_select(-1, bands))).abs().mean()

    return fn


class GAETrainer:
    def __init__(self, n_subs=16, n_ovls=4, n_colors=102, n_feats=64, lr=1e-4, la1=0.3,
                 la2=0.1, seed=0, state_dict=None, perceptual_fn=None, perceptual_weight=1e-3,
                 mask_p=0.0, loss="hloss", device=None):
        """``state_dict`` (reference keys) replaces the seeded init, torch's
        default conv init drawn from ``torch.Generator().manual_seed(seed)``.
        ``device`` defaults to CUDA and raises without it; pass
        ``device="cpu"`` to run on the CPU."""
        if loss not in ("hloss", "l1"):
            raise ValueError(f"loss must be 'hloss' or 'l1', got {loss!r}")
        self.device = resolve_device(device)
        self.config = dict(n_subs=n_subs, n_ovls=n_ovls, n_colors=n_colors, n_feats=n_feats)
        self.gae = GAE(**self.config)
        if state_dict is None:
            init_weights(self.gae, torch.Generator().manual_seed(seed))
        else:
            load_state_dict(self.gae, state_dict)
        self.gae.to(self.device)
        self.la1, self.la2 = la1, la2
        self.mask_p = mask_p
        self.loss_type = loss
        self.perceptual_fn = perceptual_fn
        self.perceptual_weight = perceptual_weight
        self.optimizer = torch.optim.Adam(self.gae.parameters(), lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8)
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 101)
        self.step = 0

    def _to_f32(self, x):
        """A batch (numpy or tensor; f16 and bf16 transfers included) as an
        f32 tensor on the device."""
        return torch.as_tensor(x, device=self.device).float()

    def loss(self, hr, generator=None, mask=None, bands=None):
        """The training loss of one HR batch (B, H, W, C), attached to the
        graph. The mask (``mask_p > 0``) and the perceptual bands are drawn
        from ``generator`` (the trainer's own by default), in that order;
        ``mask`` and ``bands`` replace the draws."""
        g = self.generator if generator is None else generator
        hr = self._to_f32(hr)
        if self.mask_p > 0 or mask is not None:
            hr = random_mask(hr, self.mask_p, generator=g, mask=mask)
        recon, _ = self.gae(hr)
        if self.loss_type == "l1":
            loss = (recon - hr).abs().mean()
        else:
            loss = h_loss(recon, hr, self.la1, self.la2)
        if self.perceptual_fn is not None:
            loss = loss + self.perceptual_weight * self.perceptual_fn(
                recon, hr, generator=g, bands=bands)
        return loss

    def compute_grads(self, hr, generator=None, mask=None, bands=None):
        """The loss of one batch, with its gradients in ``.grad``."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(hr, generator, mask, bands)
        loss.backward()
        return loss.detach()

    def apply_gradients(self):
        self.optimizer.step()
        self.step += 1

    def train_step(self, hr, generator=None, mask=None, bands=None):
        """One Adam step on an HR batch; returns the loss as a tensor on the
        device (no host sync)."""
        loss = self.compute_grads(hr, generator, mask, bands)
        self.apply_gradients()
        return loss

    # ------------------------------------------------------------- eval

    @torch.no_grad()
    def reconstruct(self, x):
        recon, _ = self.gae(self._to_f32(x))
        return recon

    # ------------------------------------------------------ checkpoints

    def save(self, path):
        """Write the GAE weights and widths into the directory ``path``
        (made if missing; a save to the same path replaces the last one)."""
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, _CKPT_FILE)
        tmp = target + ".tmp"
        torch.save({"state_dict": {k: v.detach().cpu() for k, v in self.gae.state_dict().items()},
                    "config": dict(self.config)}, tmp)
        os.replace(tmp, target)

    @staticmethod
    def load_gae_variables(path):
        """(state_dict, config) from a directory written by ``save``; the
        config also holds the group count G."""
        ckpt = torch.load(os.path.join(path, _CKPT_FILE), map_location="cpu", weights_only=True)
        cfg = {k: int(v) for k, v in ckpt["config"].items()}
        cfg["G"] = math.ceil((cfg["n_colors"] - cfg["n_ovls"]) / (cfg["n_subs"] - cfg["n_ovls"]))
        return ckpt["state_dict"], cfg
