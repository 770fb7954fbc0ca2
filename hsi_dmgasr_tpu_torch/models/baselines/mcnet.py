"""MCNet baseline (reference GAE/MCNet.py): a port of
``hsi_dmgasr_tpu/models/baselines/mcnet.py``.

Mixed 2-D/3-D convs with weight normalisation: the HSI cube is a 3-D
volume (depth = spectral bands, 1 input channel), four SSRM blocks mix
separable 3-D convs with 2-D convs applied with the depth folded into
the batch, and a weight-normed ConvTranspose3d tail (normed over torch's
dim 0, its input channels) upsamples spatially. Volumes are NDHWC
(the NCDHW view inside each conv); module names give the reference keys
(``SSRM{i}.Block{j}.0.conv.{0,1}.conv``, ``reduceF.conv``, ``Conv.conv``,
``conv{1,2,3}.{0,2}``, ``gamma``, ``tail.{0,1}``). NHWC in and out.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.blocks import Conv2d
from ...ops.extra import Conv3d, Deconv3d


class WNConv3dReLU(nn.Module):
    """A weight-normed 3-D conv and a relu; the reference's wrapper holds
    the conv as ``conv``."""

    def __init__(self, in_ch, out_ch, kernel_size, padding):
        super().__init__()
        self.conv = Conv3d(in_ch, out_ch, kernel_size, padding=padding, weight_norm=True)

    def forward(self, x):
        return torch.relu(self.conv(x))


class S3Dblock(nn.Module):
    """(1,3,3) then (3,1,1) weight-normed convs, each with a relu
    (MCNet.py:20-30)."""

    def __init__(self, n_feats):
        super().__init__()
        self.conv = nn.Sequential(WNConv3dReLU(n_feats, n_feats, (1, 3, 3), (0, 1, 1)),
                                  WNConv3dReLU(n_feats, n_feats, (3, 1, 1), (1, 0, 0)))

    def forward(self, x):
        return self.conv(x)


class WNConv2dPair(nn.Sequential):
    """conv-relu-conv, weight-normed, on the depth-folded volume
    (MCNet.py:84-100)."""

    def __init__(self, n_feats):
        super().__init__(Conv2d(n_feats, n_feats, 3, weight_norm=True), nn.ReLU(),
                         Conv2d(n_feats, n_feats, 3, weight_norm=True))

    def forward(self, x):
        b, d, h, w, c = x.shape
        return super().forward(x.reshape(b * d, h, w, c)).reshape(b, d, h, w, c)


class SSRMBlock(nn.Module):
    """MCNet Block (GAE/MCNet.py:57-128)."""

    def __init__(self, n_feats, n_conv=1):
        super().__init__()
        for j in (1, 2, 3):
            setattr(self, f"Block{j}", nn.Sequential(*[S3Dblock(n_feats) for _ in range(n_conv)]))
            setattr(self, f"conv{j}", WNConv2dPair(n_feats))
        self.gamma = nn.Parameter(torch.ones(3))
        self.reduceF = WNConv3dReLU(3 * n_feats, n_feats, (1, 1, 1), (0, 0, 0))
        self.Conv = S3Dblock(n_feats)

    def forward(self, x):
        x1 = self.Block1(x) + x
        x2 = self.Block2(x1) + x1
        x3 = self.Block3(x2) + x2
        y = torch.cat([self.gamma[0] * self.conv1(x1), self.gamma[1] * self.conv2(x2),
                       self.gamma[2] * self.conv3(x3)], -1)
        return self.Conv(self.reduceF(y) + x)


class MCNet(nn.Module):
    def __init__(self, scale=4, n_colors=31, n_feats=32, n_conv=1):
        super().__init__()
        self.head = Conv3d(1, n_feats, (3, 3, 3), weight_norm=True)
        for i in range(1, 5):
            setattr(self, f"SSRM{i}", SSRMBlock(n_feats, n_conv))
        self.tail = nn.Sequential(
            Deconv3d(n_feats, n_feats, (3, 2 + scale, 2 + scale), (1, scale, scale), (1, 1, 1),
                     weight_norm=True),
            Conv3d(n_feats, 1, (3, 3, 3), weight_norm=True))

    def forward(self, x):
        """x: (B, h, w, C) LR cube -> (B, h*scale, w*scale, C)."""
        t = self.head(x.permute(0, 3, 1, 2).unsqueeze(-1))  # (B, C, h, w, 1) NDHWC volume
        y = t
        for i in range(1, 5):
            y = getattr(self, f"SSRM{i}")(y) + t
        return self.tail(y).squeeze(-1).permute(0, 2, 3, 1)
