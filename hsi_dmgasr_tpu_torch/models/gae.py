"""Group AutoEncoder (GAE), stage 1 of DMGASR.

Port of ``hsi_dmgasr_tpu/models/gae.py`` (reference AE.py:256-361). The G
band groups are folded into the batch so the shared encoder and decoder
run once; the overlap average of decoded groups is one ``index_add_``
over the band axis divided by the per-band count. Module names give the
reference keys (``Encoder.branch...``, ``Decoder...``, ``trunk``,
``final``).

Shapes: x (B, H, W, C); latents (B, G, H, W, latent_channels).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.blocks import BranchUnit, Conv2d


def group_indices(n_colors, n_subs, n_ovls):
    """Static (G, n_subs) band-index table (AE.py:273-280)."""
    G = math.ceil((n_colors - n_ovls) / (n_subs - n_ovls))
    idx = np.zeros((G, n_subs), dtype=np.int64)
    for g in range(G):
        sta = (n_subs - n_ovls) * g
        end = sta + n_subs
        if end > n_colors:
            end = n_colors
            sta = n_colors - n_subs
        idx[g] = np.arange(sta, end)
    return idx


class GAEEncoder(nn.Module):
    """Shared group encoder: BranchUnit(n_subs -> n_feats) + 3x3 conv to
    latent_channels (AE.py:168-199)."""

    def __init__(self, n_subs, latent_channels=3, n_feats=128):
        super().__init__()
        self.branch = BranchUnit(n_subs, n_feats, n_blocks=3, res_scale=0.1,
                                 up_scale=1, use_tail=False)
        self.final = Conv2d(n_feats, latent_channels, 3)

    def forward(self, x):
        return self.final(self.branch(x))


class GAEDecoder(nn.Module):
    """Shared group decoder, the mirror of the encoder (AE.py:202-242)."""

    def __init__(self, n_subs, latent_channels=3, n_feats=128):
        super().__init__()
        self.branch = BranchUnit(latent_channels, n_feats, n_blocks=3,
                                 res_scale=0.1, up_scale=1, use_tail=False)
        self.final = Conv2d(n_feats, n_subs, 3)

    def forward(self, z):
        return self.final(self.branch(z))


class GAE(nn.Module):
    """Grouped autoencoder with overlap average and residual trunk
    (AE.py:256-361)."""

    def __init__(self, n_subs=8, n_ovls=2, n_colors=31, n_feats=128,
                 latent_channels=3):
        super().__init__()
        idx = group_indices(n_colors, n_subs, n_ovls)
        counts = np.zeros(n_colors, dtype=np.float32)
        np.add.at(counts, idx.reshape(-1), 1.0)
        self.n_subs, self.n_colors = n_subs, n_colors
        self.G = idx.shape[0]
        self.latent_channels = latent_channels
        self.register_buffer("idx", torch.from_numpy(idx.reshape(-1)), persistent=False)
        self.register_buffer("counts", torch.from_numpy(counts), persistent=False)
        self.Encoder = GAEEncoder(n_subs, latent_channels, n_feats)
        self.Decoder = GAEDecoder(n_subs, latent_channels, n_feats)
        self.trunk = BranchUnit(n_colors, n_feats=32, n_blocks=2,
                                res_scale=0.1, up_scale=1, use_tail=False)
        self.final = Conv2d(32, n_colors, 3)

    def encode(self, x):
        """(B, H, W, C) -> (B, G, H, W, latent): one batched encoder pass
        over the band groups (AE.py:310-324)."""
        b, h, w, c = x.shape
        if c != self.n_colors:
            raise ValueError(f"GAE configured for {self.n_colors} bands, got cube "
                             f"with {c} (channels-last expected)")
        xg = x.index_select(-1, self.idx).reshape(b, h, w, self.G, self.n_subs)
        xg = xg.permute(0, 3, 1, 2, 4).reshape(b * self.G, h, w, self.n_subs)
        z = self.Encoder(xg)
        return z.reshape(b, self.G, h, w, self.latent_channels)

    def _merge_groups(self, dec, b, h, w):
        """Scatter-add decoded groups into the C-band cube and average by
        per-band coverage (AE.py:288-295)."""
        dec = dec.reshape(b, self.G, h, w, self.n_subs).permute(0, 2, 3, 1, 4)
        dec = dec.reshape(b, h, w, self.G * self.n_subs)
        y = dec.new_zeros((b, h, w, self.n_colors)).index_add_(-1, self.idx, dec)
        return y / self.counts.to(dec.dtype)

    def _refine(self, y):
        """Residual refinement trunk (AE.py:302-308)."""
        return self.final(self.trunk(y)) + y

    def decode(self, z):
        """(B, G, H, W, latent) -> (B, H, W, C) (AE.py:283-308)."""
        b, g, h, w, lc = z.shape
        dec = self.Decoder(z.reshape(b * g, h, w, lc))
        return self._refine(self._merge_groups(dec, b, h, w))

    def forward(self, x):
        """Full round trip; returns (recon, latents) (AE.py:326-361)."""
        z = self.encode(x)
        return self.decode(z), z


def random_mask(data, p=0.2, generator=None, mask=None):
    """Zero a random fraction p of entries (AE.py:95-99), the masking of
    the DDP stage-1 trainer (GAE/AEddp.py:196-247): an element is kept
    where a uniform draw from ``generator`` is > p. A given boolean
    ``mask`` (True = keep) replaces the draw."""
    if mask is None:
        mask = torch.rand(data.shape, generator=generator, device=data.device) > p
    return data * torch.as_tensor(mask, device=data.device).to(data.dtype)
