"""Exact fusion of nearest-x2 upsample + 3x3 SAME conv (the SR3 UNet
up-path boundary, reference model/sr3_modules/unet.py:146-152).

Port of ``hsi_dmgasr_tpu/ops/fused_up.py``. Nearest-x2 repeats each
source pixel 2x2, so conv3x3(nearest_x2(x)) is one stride-2 transposed
convolution of x with a 4x4 kernel whose taps are sums of the 3x3 taps,
[K0, K0+K1, K1+K2, K2] along each axis (``_compose_up2``): the upsampled
intermediate is never materialised.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _compose_up2(kernel):
    """(3, 3, C, Cout) HWIO -> (4, 4, C, Cout): conv3x3 composed with
    nearest-x2, as the kernel of an input-dilated convolution."""

    def expand(k, dim):
        k0, k1, k2 = k.unbind(dim)
        return torch.stack([k0, k0 + k1, k1 + k2, k2], dim)

    return expand(expand(kernel, 0), 1)


def up2_conv3x3(x, kernel, bias=None):
    """nearest-x2 upsample then 3x3 SAME conv.

    x: (B, H, W, C); kernel: (3, 3, C, Cout) HWIO; bias: (Cout,).
    Returns (B, 2H, 2W, Cout). An input-dilated convolution with the
    composed kernel is a transposed convolution with that kernel flipped,
    in torch's (C, Cout, kh, kw) layout. As in the JAX package, the taps
    are composed in the kernel's dtype and cast to x.dtype, and the bias
    is added in the output's dtype.
    """
    w = _compose_up2(kernel).flip(0, 1).permute(2, 3, 0, 1).to(x.dtype)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2, padding=1)
    if bias is not None:
        out.add_(bias.to(out.dtype)[:, None, None])
    return out.permute(0, 2, 3, 1).contiguous()
