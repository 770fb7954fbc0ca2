"""Group AutoEncoder (GAE), stage 1 of DMGASR.

Port of ``hsi_dmgasr_tpu/models/gae.py`` (reference AE.py:256-361). The G
band groups are folded into the batch so the shared encoder and decoder
run once; the overlap average of decoded groups is one ``index_add_``
over the band axis divided by the per-band count. Module names give the
reference keys (``Encoder.branch...``, ``Decoder...``, ``trunk``,
``final``).

The variants of the reference beside it: ``GAE(use_trunk=False)`` (the
symmetric AE_duichen, no trunk), ``SREncoder`` (encoder only), ``AE``
(ungrouped, with the trunk), ``PostGAE`` (the standalone refinement net)
and ``ToyAutoencoder`` (the 33-band conv/max-pool toy, its layers named
as the JAX package names them: ``enc0``..``enc2``, ``dec0``..``dec2``).

Shapes: x (B, H, W, C); latents (B, G, H, W, latent_channels).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.blocks import BranchUnit, Conv2d
from ..ops.extra import Deconv2d


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


class _Grouped(nn.Module):
    """The band groups of a grouped model and its shared encoder."""

    def __init__(self, n_subs, n_ovls, n_colors, n_feats, latent_channels):
        super().__init__()
        idx = group_indices(n_colors, n_subs, n_ovls)
        self.n_subs, self.n_colors = n_subs, n_colors
        self.G = idx.shape[0]
        self.latent_channels = latent_channels
        self.register_buffer("idx", torch.from_numpy(idx.reshape(-1)), persistent=False)
        self.Encoder = GAEEncoder(n_subs, latent_channels, n_feats)

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


class GAE(_Grouped):
    """Grouped autoencoder with overlap average and residual trunk
    (AE.py:256-361); ``use_trunk=False`` is the symmetric AE_duichen
    (AE.py:433-513): no ``trunk`` and no ``final``, decode the bare
    overlap average."""

    def __init__(self, n_subs=8, n_ovls=2, n_colors=31, n_feats=128,
                 latent_channels=3, use_trunk=True):
        super().__init__(n_subs, n_ovls, n_colors, n_feats, latent_channels)
        counts = np.zeros(n_colors, dtype=np.float32)
        np.add.at(counts, self.idx.numpy(), 1.0)
        self.register_buffer("counts", torch.from_numpy(counts), persistent=False)
        self.Decoder = GAEDecoder(n_subs, latent_channels, n_feats)
        self.trunk = self.final = None
        if use_trunk:
            self.trunk = BranchUnit(n_colors, n_feats=32, n_blocks=2,
                                    res_scale=0.1, up_scale=1, use_tail=False)
            self.final = Conv2d(32, n_colors, 3)

    def _merge_groups(self, dec, b, h, w):
        """Scatter-add decoded groups into the C-band cube and average by
        per-band coverage (AE.py:288-295)."""
        dec = dec.reshape(b, self.G, h, w, self.n_subs).permute(0, 2, 3, 1, 4)
        dec = dec.reshape(b, h, w, self.G * self.n_subs)
        y = dec.new_zeros((b, h, w, self.n_colors)).index_add_(-1, self.idx, dec)
        return y / self.counts.to(dec.dtype)

    def _refine(self, y):
        """Residual refinement trunk (AE.py:302-308)."""
        if self.trunk is None:
            return y
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


class SREncoder(_Grouped):
    """The encoder-only grouped model (AE.py:365-401): (B, H, W, C) ->
    (B, G, H, W, latent)."""

    def __init__(self, n_subs=8, n_ovls=2, n_colors=31, n_feats=128, latent_channels=3):
        super().__init__(n_subs, n_ovls, n_colors, n_feats, latent_channels)

    def forward(self, x):
        return self.encode(x)


class AE(nn.Module):
    """The ungrouped autoencoder with the refinement trunk (AE.py:404-430)."""

    def __init__(self, in_channels=102, n_feats=128, latent_channels=3):
        super().__init__()
        self.Encoder = GAEEncoder(in_channels, latent_channels, n_feats)
        self.Decoder = GAEDecoder(in_channels, latent_channels, n_feats)
        self.trunk = BranchUnit(in_channels, n_feats=32, n_blocks=2, res_scale=0.1,
                                up_scale=1, use_tail=False)
        self.final = Conv2d(32, in_channels, 3)

    def encode(self, x):
        return self.Encoder(x)

    def decode(self, z):
        y = self.Decoder(z)
        return self.final(self.trunk(y)) + y

    def forward(self, x):
        z = self.encode(x)
        return self.decode(z), z


class PostGAE(nn.Module):
    """The standalone post-refinement net (AE.py:244-252): BranchUnit(256
    features, 3 blocks) then a 3x3 conv, applied to a decoded cube."""

    def __init__(self, n_colors):
        super().__init__()
        self.trunk = BranchUnit(n_colors, n_feats=256, n_blocks=3, res_scale=0.1,
                                up_scale=1, use_tail=False)
        self.final = Conv2d(256, n_colors, 3)

    def forward(self, x):
        return self.final(self.trunk(x))


class ToyAutoencoder(nn.Module):
    """The reference's 33-band toy autoencoder (AE.py:57-92): three 3x3
    conv + ReLU layers with 2x2 max-pools down to a 3-channel latent at
    a quarter of the size, then three transposed convs + ReLU back.
    Returns (reconstruction, latent)."""

    def __init__(self, in_channels=33):
        super().__init__()
        self.enc0 = Conv2d(in_channels, 16, 3)
        self.enc1 = Conv2d(16, 8, 3)
        self.enc2 = Conv2d(8, 3, 3)
        self.dec0 = Deconv2d(3, 8, 3, 1, 1)
        self.dec1 = Deconv2d(8, 16, 3, 2, 1, output_padding=1)
        self.dec2 = Deconv2d(16, in_channels, 3, 2, 1, output_padding=1)

    @staticmethod
    def _pool(x):
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)

    def forward(self, x):
        y = self._pool(torch.relu(self.enc0(x)))
        y = self._pool(torch.relu(self.enc1(y)))
        z = torch.relu(self.enc2(y))
        y = torch.relu(self.dec0(z))
        y = torch.relu(self.dec1(y))
        return torch.relu(self.dec2(y)), z


def random_mask(data, p=0.2, generator=None, mask=None):
    """Zero a random fraction p of entries (AE.py:95-99), the masking of
    the DDP stage-1 trainer (GAE/AEddp.py:196-247): an element is kept
    where a uniform draw from ``generator`` is > p. A given boolean
    ``mask`` (True = keep) replaces the draw."""
    if mask is None:
        mask = torch.rand(data.shape, generator=generator, device=data.device) > p
    return data * torch.as_tensor(mask, device=data.device).to(data.dtype)
