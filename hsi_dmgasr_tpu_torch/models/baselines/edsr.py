"""EDSR baseline on HSI bands (reference GAE/EDSR.py:54-104): a port of
``hsi_dmgasr_tpu/models/baselines/edsr.py``.

head conv, n ResBlocks and a conv with a long skip, a pixel-shuffle
upsampler and a tail conv; the reference pins scale 2. Its modules give
the reference keys ``head.0``, ``body.N.body.{0,2}``,
``body.{n_resblocks}``, ``tail.0.0`` and ``tail.1``. NHWC in and out.
"""

from __future__ import annotations

from torch import nn

from ...ops.blocks import Conv2d, ResBlock, Upsampler


class EDSR(nn.Module):
    def __init__(self, n_resblocks=16, n_feats=64, n_colors=102, res_scale=1.0, scale=2):
        super().__init__()
        self.head = nn.Sequential(Conv2d(n_colors, n_feats, 3))
        self.body = nn.Sequential(
            *[ResBlock(n_feats, 3, nn.ReLU(), res_scale) for _ in range(n_resblocks)],
            Conv2d(n_feats, n_feats, 3))
        self.tail = nn.Sequential(Upsampler(scale, n_feats), Conv2d(n_feats, n_colors, 3))

    def forward(self, x):
        x = self.head(x)
        return self.tail(self.body(x) + x)
