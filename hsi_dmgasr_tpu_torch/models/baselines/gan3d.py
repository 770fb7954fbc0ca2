"""3-D attention GAN baseline (reference GAE/net.py, GAN-HSI-SR): a port
of ``hsi_dmgasr_tpu/models/baselines/gan3d.py``.

Generator: a 3-D conv stem, three band-attention blocks (3-D convs + a
spectral squeeze-excite over the band axis), two bicubic x2 stages with a
shared 3-D conv refining each. Discriminator: a strided 3-D conv pyramid
with BatchNorm (flax's rules, ``models/unet.py:BatchNorm``), a global
pool and an MLP head. ``spe_loss_gan`` is the reference's per-pixel
spectral-angle loop (net.py:244-262) as one reduction.

Volumes are NDHWC with D = bands (the NCDHW view inside each conv);
kernel (5, 3, 3), padding (2, 1, 1) throughout (net.py:19-20). Module
names give the reference keys (``conv_1.0``, ``attn_N.conv_{1,2}.{0,2}``,
``conv_4.0``; the discriminator's ``conv.N`` Sequential and ``linera``).
NHWC cubes in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.extra import Conv3d, make_torch_bicubic
from ..unet import BatchNorm

_K = (5, 3, 3)
_P = (2, 1, 1)


def conv3d(in_ch, out_ch, stride=1, padding=_P):
    return Conv3d(in_ch, out_ch, _K, stride=stride, padding=padding)


def lrelu():
    return nn.LeakyReLU(0.01)


class BandAttention(nn.Module):
    """Band attention (net.py:23-72): two 3-D convs, a squeeze-excite MLP
    over the band axis of their (H, W)-pooled features, residual."""

    def __init__(self, n_bands=31):
        super().__init__()
        self.conv_1 = nn.Sequential(conv3d(32, 32), lrelu(), conv3d(32, 32), lrelu())
        self.conv_2 = nn.Sequential(nn.Linear(n_bands, 8, bias=False), lrelu(),
                                    nn.Linear(8, n_bands, bias=False), nn.Sigmoid())

    def forward(self, x):
        x1 = self.conv_1(x)  # (B, L, H, W, C)
        # AdaptiveAvgPool3d((L, 1, 1)): the mean over H, W keeps the band axis
        w = self.conv_2(x1.mean((2, 3)).transpose(1, 2))  # (B, C, L)
        return x + x1 * w.transpose(1, 2)[:, :, None, None, :]


class Generator(nn.Module):
    """The x4 generator (net.py:75-131): (B, h, w, L) -> (B, 4h, 4w, L)."""

    def __init__(self, n_bands=31):
        super().__init__()
        self.conv_1 = nn.Sequential(conv3d(1, 32), lrelu())
        self.attn_1, self.attn_2, self.attn_3 = (BandAttention(n_bands) for _ in range(3))
        self.conv_2 = nn.Sequential(conv3d(32, 32), lrelu())
        self.conv_3 = conv3d(32, 1)
        self.conv_4 = nn.Sequential(conv3d(1, 1), lrelu())  # applied three times
        self.conv_5 = conv3d(1, 1)

    @staticmethod
    def _up2(t):
        """(B, L, H, W) -> (B, L, 2H, 2W): the bicubic x2 of torch, which
        reads (B, L, H, W) as NCHW; back as a 1-channel NDHWC volume."""
        h, w = t.shape[2], t.shape[3]
        up = make_torch_bicubic((h, w), (2 * h, 2 * w), device=t.device)
        return up(t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).unsqueeze(-1)

    def forward(self, x):
        x1 = self.conv_1(x.permute(0, 3, 1, 2).unsqueeze(-1))  # (B, L, h, w, 32)
        x3 = self.conv_2(self.attn_3(self.attn_2(self.attn_1(x1)))) + x1
        t = self.conv_4(self._up2(self.conv_3(x3)[..., 0]))
        t = self.conv_4(self.conv_4(self._up2(t[..., 0])))
        return self.conv_5(t)[..., 0].permute(0, 2, 3, 1)


class OnePad(nn.Module):
    """The one-sided pad ((1, 2), (1, 0), (1, 0)) over (D, H, W) with value
    1.0 before each stride-2 conv (net.py:134-185); F.pad lists the axes
    from the last, C, backwards."""

    def forward(self, y):
        return F.pad(y, (0, 0, 1, 0, 1, 0, 1, 2), value=1.0)


class Discriminator(nn.Module):
    """The 3-D conv pyramid + MLP head (net.py:134-185): (B, H, W, L) ->
    (B, 1). Its BatchNorms follow flax's rules: in train mode the batch's
    biased variance, running = 0.9 running + 0.1 batch."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Sequential(
            conv3d(1, 32), lrelu(), OnePad(),
            conv3d(32, 32, 2, (0, 0, 0)), BatchNorm(32), lrelu(),
            conv3d(32, 64), BatchNorm(64), lrelu(), OnePad(),
            conv3d(64, 64, 2, (0, 0, 0)), BatchNorm(64), lrelu(),
            conv3d(64, 128), BatchNorm(128), lrelu(),
            conv3d(128, 128), BatchNorm(128), lrelu())
        self.linera = nn.Sequential(nn.Linear(128, 256), lrelu(), nn.Linear(256, 1),
                                    nn.Sigmoid())

    def forward(self, x):
        y = self.conv(x.permute(0, 3, 1, 2).unsqueeze(-1))
        return self.linera(y.mean((1, 2, 3)))


def spe_loss_gan(x, y):
    """The mean per-pixel spectral angle (net.py:244-262). x, y: (B, H, W,
    L); the reference sums the inner products over batch and bands."""
    fz = (x * y).sum((0, 3))
    fm = (x * x).sum((0, 3)).sqrt() * (y * y).sum((0, 3)).sqrt()
    return torch.arccos((fz / fm.clamp_min(1e-12)).clamp(-1.0, 1.0)).mean()


def ragan_d_loss(d_real, d_fake, eps=1e-8):
    """Relativistic average GAN discriminator loss (GAE/train.py:84-199)."""
    real_rel = torch.sigmoid(d_real - d_fake.mean())
    fake_rel = torch.sigmoid(d_fake - d_real.mean())
    return -torch.log(real_rel + eps).mean() - torch.log(1.0 - fake_rel + eps).mean()


def ragan_g_loss(d_real, d_fake, eps=1e-8):
    """The generator's side of the RaGAN loss."""
    real_rel = torch.sigmoid(d_real - d_fake.mean())
    fake_rel = torch.sigmoid(d_fake - d_real.mean())
    return -torch.log(fake_rel + eps).mean() - torch.log(1.0 - real_rel + eps).mean()
