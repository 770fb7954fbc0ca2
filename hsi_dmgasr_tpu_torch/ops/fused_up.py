"""Exact fusion of nearest-x2 upsample + 3x3 SAME conv (the SR3 UNet
up-path boundary, reference model/sr3_modules/unet.py:146-152).

Port of ``hsi_dmgasr_tpu/ops/fused_up.py``. Nearest-x2 repeats each
source pixel 2x2, so conv3x3(nearest_x2(x)) is one stride-2 transposed
convolution of x with a 4x4 kernel whose taps are sums of the 3x3 taps,
[K0, K0+K1, K1+K2, K2] along each axis (``_compose_up2``): the upsampled
intermediate is never materialised. Equivalently each output parity (a, c)
is a 2x2 convolution of x (``parity_taps``): per axis, parity 0 reads
source rows (i-1, i) with (K0, K1+K2), parity 1 rows (i, i+1) with
(K0+K1, K2).

``up2_conv3x3`` routes a CUDA f32 call whose channels the kernel takes to
``kernels/up2_conv.py`` (the four parities on ``wgmma``, f32 operands as
bf16 hi + lo pairs), on weights its caller packed once per weight
version; the CPU, bf16 and any other call to ``up2_conv3x3_transpose``.
``up2_conv3x3_parity`` is the kernel's mathematics in plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import up2_conv
from ..kernels.build import split_bf16


def _compose_up2(kernel):
    """(3, 3, C, Cout) HWIO -> (4, 4, C, Cout): conv3x3 composed with
    nearest-x2, as the kernel of an input-dilated convolution."""

    def expand(k, dim):
        k0, k1, k2 = k.unbind(dim)
        return torch.stack([k0, k0 + k1, k1 + k2, k2], dim)

    return expand(expand(kernel, 0), 1)


def parity_taps(kernel):
    """(3, 3, C, Cout) -> (2, 2, 2, 2, C, Cout) f32 [a, c, dy, dx]: the 2x2
    taps of output parity (a, c), tap (dy, dx) reading source pixel
    (i + a - 1 + dy, j + c - 1 + dx). They are ``_compose_up2``'s taps
    [a + 2 dy, c + 2 dx], composed in f32."""
    k = _compose_up2(kernel.float())
    c, cout = k.shape[2:]
    return k.reshape(2, 2, 2, 2, c, cout).permute(1, 3, 0, 2, 4, 5)


def up2_conv3x3_transpose(x, kernel, bias=None):
    """nearest-x2 upsample then 3x3 SAME conv, as one transposed conv.

    An input-dilated convolution with the composed kernel is a transposed
    convolution with that kernel flipped, in torch's (C, Cout, kh, kw)
    layout. As in the JAX package, the taps are composed in the kernel's
    dtype and cast to x.dtype, and the bias is added in the output's dtype.
    """
    w = _compose_up2(kernel).flip(0, 1).permute(2, 3, 0, 1).to(x.dtype)
    out = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2, padding=1)
    if bias is not None:
        out.add_(bias.to(out.dtype)[:, None, None])
    return out.permute(0, 2, 3, 1).contiguous()


def up2_conv3x3_parity(x, kernel, bias=None):
    """The kernel's mathematics in plain PyTorch: each output parity (a, c)
    a 2x2 convolution of the zero-padded x with ``parity_taps``, x and the
    taps split into bf16 hi + lo pairs and summed in f32 as the products
    x_hi W_hi + x_lo W_hi + x_hi W_lo, then the bias in f32. Returns
    (B, 2H, 2W, Cout) in x.dtype."""
    b, h, w, _ = x.shape
    w_hi, w_lo = split_bf16(parity_taps(kernel))
    x_hi, x_lo = split_bf16(F.pad(x.float(), (0, 0, 1, 1, 1, 1)))
    out = x.new_empty((b, h, 2, w, 2, kernel.shape[-1]), dtype=torch.float32)
    for a in (0, 1):
        for c in (0, 1):
            acc = 0.0
            for dy in (0, 1):
                for dx in (0, 1):
                    rows, cols = slice(a + dy, a + dy + h), slice(c + dx, c + dx + w)
                    xh, xl = x_hi[:, rows, cols], x_lo[:, rows, cols]
                    wh, wl = w_hi[a, c, dy, dx], w_lo[a, c, dy, dx]
                    acc = acc + xh @ wh + xl @ wh + xh @ wl
            out[:, :, a, :, c] = acc
    out = out.reshape(b, 2 * h, 2 * w, -1)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def up2_conv3x3(x, kernel, bias=None, packed=None):
    """nearest-x2 upsample then 3x3 SAME conv.

    x: (B, H, W, C); kernel: (3, 3, C, Cout) HWIO; bias: (Cout,).
    Returns (B, 2H, 2W, Cout). A CUDA f32 call whose channels the kernel
    takes (``kernels/up2_conv.py:takes``) runs the kernel on ``packed``,
    the taps ``up2_conv.pack_up2(parity_taps(kernel))`` that the caller
    keeps per weight version (``models/unet.py:Upsample``), packed here when
    not given; any other ``up2_conv3x3_transpose``.
    ``up2_conv.LAUNCHES_BY_ROUTE`` counts both.
    """
    if up2_conv.takes(x, kernel):
        if packed is None:
            packed = up2_conv.pack_up2(parity_taps(kernel))
        return up2_conv.up2_conv3x3(x, packed, bias)
    up2_conv.LAUNCHES_BY_ROUTE["transpose"] += 1
    return up2_conv3x3_transpose(x, kernel, bias)
