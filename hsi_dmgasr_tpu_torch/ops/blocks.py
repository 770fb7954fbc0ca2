"""Shared conv building blocks (PyTorch, NHWC activations).

Port of ``hsi_dmgasr_tpu/ops/blocks.py`` (reference common.py:19-126 and
the SSPSR block family in AE.py:102-165). Activations are NHWC as in the
JAX package; weights keep torch's layout (OIHW convs, (out, in) linears)
and the module names give the reference's state_dict keys (``head``,
``body.net.N.spa.body.0``, ``spc.body.3.conv_du.0``, ...), so the
shipped ``.pth`` files load as they are. The JAX package's ``Dense`` is
``nn.Linear`` here, and its ``leaky_relu`` is ``nn.LeakyReLU(0.01)``. A
conv sees the NCHW view of its NHWC input, whose channels-last strides
cuDNN takes as they are, and hands back the NHWC view of its output.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .extra import _weight, _weight_norm


class Conv2d(nn.Conv2d):
    """torch.nn.Conv2d on NHWC tensors, padding k//2 * dilation (the
    reference's ``default_conv``, common.py:19-32). As in the JAX
    package, the kernel is cast to x.dtype and the bias is added in the
    output's dtype, so bf16 weights serve an f32 input and the reverse.
    ``groups`` is torch's (GDRRN's grouped and CEGATSR's depthwise convs);
    ``weight_norm`` keeps ``weight_g``/``weight_v`` as
    torch.nn.utils.weight_norm does (MCNet's 2-D convs, ``ops/extra.py``)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 bias=True, dilation=1, groups=1, weight_norm=False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=(kernel_size // 2) * dilation,
                         dilation=dilation, groups=groups, bias=bias)
        self.weight_norm = weight_norm
        if weight_norm:
            _weight_norm(self)

    def forward(self, x):
        y = self._conv_forward(x.permute(0, 3, 1, 2), _weight(self).to(x.dtype), None)
        if self.bias is not None:
            y.add_(self.bias.to(y.dtype)[:, None, None])
        return y.permute(0, 2, 3, 1).contiguous()


def pixel_shuffle(x, r):
    """torch.nn.PixelShuffle semantics in NHWC:
    out[b, h*r+i, w*r+j, c] = x[b, h, w, c*r*r + i*r + j]."""
    b, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)


class PixelShuffle(nn.Module):
    def __init__(self, r):
        super().__init__()
        self.r = r

    def forward(self, x):
        return pixel_shuffle(x, self.r)


class CALayer(nn.Module):
    """Channel attention: GAP -> 1x1 squeeze/excite convs -> sigmoid gate
    (common.py:35-51)."""

    def __init__(self, channel, reduction=16):
        super().__init__()
        self.conv_du = nn.Sequential(
            Conv2d(channel, channel // reduction, 1), nn.ReLU(),
            Conv2d(channel // reduction, channel, 1), nn.Sigmoid())

    def forward(self, x):
        return x * self.conv_du(x.mean((1, 2), keepdim=True))


class ResBlock(nn.Module):
    """conv-act-conv residual block with res_scale (common.py:54-73)."""

    def __init__(self, n_feats, kernel_size=3, act=None, res_scale=1.0):
        super().__init__()
        act = act if act is not None else nn.ReLU()
        self.body = nn.Sequential(Conv2d(n_feats, n_feats, kernel_size), act,
                                  Conv2d(n_feats, n_feats, kernel_size))
        self.res_scale = res_scale

    def forward(self, x):
        return self.body(x) * self.res_scale + x


class ResAttentionBlock(nn.Module):
    """ResBlock + channel-attention tail (common.py:76-97)."""

    def __init__(self, n_feats, kernel_size=3, act=None, res_scale=1.0,
                 ca_reduction=3):
        super().__init__()
        act = act if act is not None else nn.ReLU()
        self.body = nn.Sequential(Conv2d(n_feats, n_feats, kernel_size), act,
                                  Conv2d(n_feats, n_feats, kernel_size),
                                  CALayer(n_feats, ca_reduction))
        self.res_scale = res_scale

    def forward(self, x):
        return self.body(x) * self.res_scale + x


class SSB(nn.Module):
    """Spatial-spectral block: 3x3 ResBlock then 1x1 ResAttentionBlock
    (AE.py:102-109)."""

    def __init__(self, n_feats, kernel_size=3, act=None, res_scale=0.1,
                 ca_reduction=3):
        super().__init__()
        act = act if act is not None else nn.LeakyReLU(0.01)
        self.spa = ResBlock(n_feats, kernel_size, act, res_scale)
        self.spc = ResAttentionBlock(n_feats, 1, act, res_scale, ca_reduction)

    def forward(self, x):
        return self.spc(self.spa(x))


class SSPN(nn.Module):
    """n_blocks SSBs with a long skip (AE.py:120-141)."""

    def __init__(self, n_feats, n_blocks, act=None, res_scale=0.1,
                 ca_reduction=3):
        super().__init__()
        self.net = nn.Sequential(*[
            SSB(n_feats, 3, act, res_scale, ca_reduction) for _ in range(n_blocks)])

    def forward(self, x):
        return self.net(x) + x


class Upsampler(nn.Sequential):
    """PixelShuffle upsampling chain for scale 2^n or 3 (common.py:100-126);
    scale 1 is the identity (no stages)."""

    def __init__(self, scale, n_feats):
        layers = []
        if scale == 1:
            pass
        elif scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [Conv2d(n_feats, 4 * n_feats, 3), PixelShuffle(2)]
        elif scale == 3:
            layers += [Conv2d(n_feats, 9 * n_feats, 3), PixelShuffle(3)]
        else:
            raise NotImplementedError(f"Upsampler scale {scale}")
        super().__init__(*layers)


class BranchUnit(nn.Module):
    """head conv -> SSPN -> Upsampler -> optional tail (AE.py:145-165)."""

    def __init__(self, n_colors, n_feats, n_blocks, act=None, res_scale=0.1,
                 up_scale=1, use_tail=True):
        super().__init__()
        self.head = Conv2d(n_colors, n_feats, 3)
        self.body = SSPN(n_feats, n_blocks, act, res_scale)
        self.upsample = Upsampler(up_scale, n_feats)
        self.tail = Conv2d(n_feats, n_colors, 3) if use_tail else None

    def forward(self, x):
        y = self.upsample(self.body(self.head(x)))
        return self.tail(y) if self.tail is not None else y
