"""SSPSR baseline (reference SSPSR.py:64-138): a port of
``hsi_dmgasr_tpu/models/baselines/sspsr.py``.

Grouped spatial-spectral prior network: a SHARED BranchUnit upsamples
each band group by n_scale // 2 (the groups folded into the batch, one
pass), the groups are overlap-averaged (``index_add_``), a trunk
upsamples the rest (x2), and a bicubic skip of ``lms`` upsampled by
n_scale with align_corners=True (SSPSR.py:124-130) enters through a skip
conv. ``use_share=False`` gives each group its own BranchUnit (x2),
``branch.{g}``. NHWC in and out.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.blocks import BranchUnit, Conv2d
from ...ops.extra import make_torch_bicubic
from .groups import BandGroups


class SSPSR(nn.Module):
    def __init__(self, n_subs, n_ovls, n_colors, n_blocks=3, n_feats=256, n_scale=4,
                 res_scale=0.1, use_share=True):
        super().__init__()
        self.groups = BandGroups(n_colors, n_subs, n_ovls)
        self.n_scale, self.sca, self.use_share = n_scale, n_scale // 2, use_share
        if use_share:
            self.branch = BranchUnit(n_subs, n_feats, n_blocks, nn.ReLU(), res_scale,
                                     up_scale=self.sca)
        else:
            self.branch = nn.ModuleList(
                BranchUnit(n_subs, n_feats, n_blocks, nn.ReLU(), res_scale, up_scale=2)
                for _ in range(self.groups.G))
        self.trunk = BranchUnit(n_colors, n_feats, n_blocks, nn.ReLU(), res_scale, up_scale=2,
                                use_tail=False)
        self.skip_conv = Conv2d(n_colors, n_feats, 3)
        self.final = Conv2d(n_feats, n_colors, 3)

    def forward(self, x, lms):
        """x: (B, h, w, C) LR cube; lms: (B, h', w', C), upsampled here by
        n_scale (the trainer passes the LR cube itself)."""
        b, h, w, _ = x.shape
        if self.use_share:
            yg = self.branch(self.groups.fold(x))
        else:
            n = self.groups.n_subs
            yg = torch.stack([br(x[..., s:s + n]) for br, s in zip(self.branch,
                                                                   self.groups.starts)], 1)
            yg = yg.reshape(b * self.groups.G, *yg.shape[2:])
        y = self.trunk(self.groups.merge(yg, b))
        hw = (lms.shape[1], lms.shape[2])
        up = make_torch_bicubic(hw, (hw[0] * self.n_scale, hw[1] * self.n_scale),
                                align_corners=True, device=lms.device)(lms)
        return self.final(y + self.skip_conv(up))
