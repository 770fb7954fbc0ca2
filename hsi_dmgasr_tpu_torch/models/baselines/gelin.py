"""GELIN baseline (reference GELIN.py:100-276): a port of
``hsi_dmgasr_tpu/models/baselines/gelin.py``.

A group-wise SSELM encoder (SCconv self-calibrated convs + channel
attention), the NGIM neighbour-group interaction upsampler (a
transposed-conv trunk + multi-group error correction), a per-group recon
conv, the overlap average, plus the bicubic-upsampled global skip
(y + lms). The shared SSELM runs once over the (B*G) folded groups; the
neighbour groups of NGIM (GELIN.py:254-266, circular) are ``torch.roll``
over the group axis. Module names give the reference keys
(``branch.body.N.body.{0,1}``, ``f1.0``, ``f2.1``, ``conv_du.{1,3}``,
``branch_up.TrunkUp``, ``MultiUp``, ``error_resblock``). NHWC in and out.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.blocks import Conv2d
from ...ops.extra import Deconv2d, PReLU, avg_pool, resize_nearest
from .groups import BandGroups


class AvgPool(nn.Module):
    """torch.nn.AvgPool2d(r) on NHWC."""

    def __init__(self, r):
        super().__init__()
        self.r = r

    def forward(self, x):
        return avg_pool(x, self.r)


class CA(nn.Module):
    """conv-relu-conv + squeeze-excite gate, residual (GELIN.py:69-96)."""

    def __init__(self, n_feats, reduction=16):
        super().__init__()
        self.body = nn.Sequential(Conv2d(n_feats, n_feats, 3), nn.ReLU(),
                                  Conv2d(n_feats, n_feats, 3))
        # index 0 is the reference's AdaptiveAvgPool2d(1): the mean below
        self.conv_du = nn.Sequential(nn.Identity(), Conv2d(n_feats, n_feats // reduction, 1),
                                     nn.ReLU(), Conv2d(n_feats // reduction, n_feats, 1),
                                     nn.Sigmoid())

    def forward(self, x):
        y = self.body(x)
        return y * self.conv_du(y.mean((1, 2), keepdim=True)) + x


class SCconv(nn.Module):
    """Self-calibrated conv (GELIN.py:100-125): the first half of the
    channels is gated by a pooled-and-upsampled calibration branch."""

    def __init__(self, n_feats, pooling_r=4):
        super().__init__()
        half = n_feats // 2
        self.half = half
        self.f1 = nn.Sequential(Conv2d(half, half, 3), nn.ReLU())
        self.f2 = nn.Sequential(AvgPool(pooling_r), Conv2d(half, half, 3))
        self.f3 = Conv2d(half, half, 3)
        self.f4 = nn.Sequential(Conv2d(half, half, 3), nn.ReLU())

    def forward(self, x):
        x1, x2 = x[..., :self.half], x[..., self.half:]
        cal = resize_nearest(self.f2(x1), (x1.shape[1], x1.shape[2]))
        out1 = self.f4(self.f3(x1) * torch.sigmoid(x1 + cal))
        return torch.cat([out1, self.f1(x2)], -1)


class SSELB(nn.Module):
    def __init__(self, n_feats, pooling_r=4):
        super().__init__()
        self.body = nn.Sequential(SCconv(n_feats, pooling_r), CA(n_feats))

    def forward(self, x):
        return self.body(x) + x


class SSELM(nn.Module):
    """head conv + n SSELBs with a long skip (GELIN.py:186-199)."""

    def __init__(self, n_colors, n_feats, n_blocks, pooling_r=4):
        super().__init__()
        self.head = Conv2d(n_colors, n_feats, 3)
        self.body = nn.Sequential(*[SSELB(n_feats, pooling_r) for _ in range(n_blocks)])

    def forward(self, x):
        x = self.head(x)
        return self.body(x) + x


# NGIM's transposed-conv geometry (kernel, stride, padding) by scale:
# GELIN.py:142-179 (x4, x8) and GAE/GELIN.py:182-205 (x2)
_NGIM_GEOMETRY = {2: (4, 2, 1), 4: (8, 4, 2), 8: (12, 8, 2)}


class NGIM(nn.Module):
    """Neighbour-group interaction upsampler (GELIN.py:142-179)."""

    def __init__(self, n_feats, scale):
        super().__init__()
        if scale not in _NGIM_GEOMETRY:
            raise NotImplementedError(f"NGIM scale {scale}")
        k, s, p = _NGIM_GEOMETRY[scale]
        self.TrunkUp = nn.Sequential(Deconv2d(n_feats, n_feats, k, s, p), PReLU(n_feats))
        self.MultiUp = nn.Sequential(Conv2d(3 * n_feats, n_feats // 2, 3),
                                     Conv2d(n_feats // 2, n_feats, 3),
                                     Deconv2d(n_feats, n_feats, k, s, p), PReLU(n_feats))
        self.error_resblock = nn.Sequential(Conv2d(n_feats, n_feats, 3))

    def forward(self, xl, xi, xn):
        h1 = self.TrunkUp(xi)
        h2 = self.MultiUp(torch.cat([xl, xi, xn], -1))
        return h1 + self.error_resblock(h2 - h1)


class GELIN(nn.Module):
    def __init__(self, n_feats=64, n_colors=102, pooling_r=4, n_subs=16, n_ovls=4, blocks=4,
                 scale=4):
        super().__init__()
        self.groups = BandGroups(n_colors, n_subs, n_ovls)
        self.n_feats = n_feats
        self.branch = SSELM(n_subs, n_feats, blocks, pooling_r)
        self.branch_up = NGIM(n_feats, scale)
        self.branch_recon = Conv2d(n_feats, n_subs, 3)

    def forward(self, x, lms):
        """x: (B, h, w, C) LR; lms: (B, h*scale, w*scale, C) bicubic-up."""
        b, h, w, _ = x.shape
        g = self.groups.G
        m = self.branch(self.groups.fold(x)).reshape(b, g, h, w, self.n_feats)
        # circular neighbour groups (GELIN.py:254-266)
        xl, xn = torch.roll(m, 1, 1), torch.roll(m, -1, 1)
        fold = lambda t: t.reshape(b * g, h, w, self.n_feats)  # noqa: E731
        rec = self.branch_recon(self.branch_up(fold(xl), fold(m), fold(xn)))
        return self.groups.merge(rec, b) + lms
