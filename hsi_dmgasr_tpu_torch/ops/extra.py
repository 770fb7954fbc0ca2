"""Extra ops of the baseline model zoo (PyTorch, NHWC / NDHWC activations).

Port of ``hsi_dmgasr_tpu/ops/extra.py``: the torch layers SSPSR, GELIN,
MCNet and GDRRN use (ConvTranspose2d/3d, PReLU, AvgPool2d, Conv3d with
MCNet's optional weight normalisation), a nearest resize and the
torch-style bicubic resize as two matrix products.

Weights keep torch's layouts and names (``weight``, ``bias``; a PReLU's
slope is ``weight``; a weight-normed layer holds ``weight_g`` and
``weight_v`` as ``torch.nn.utils.weight_norm`` names them), so
``io/convert_torch.py:load_jax_params`` moves the JAX package's
parameters in: a transposed conv's (in, out, k...) weight from its
(k..., in, out) kernel, a conv's (out, in, k...) from (k..., in, out).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.interp import _cubic_torch
from ..device import resolve_device

_WN_EPS = 1e-12  # under the square root of the weight norm, as the JAX package's _wn_kernel


class PReLU(nn.PReLU):
    """torch.nn.PReLU(channels) on channels-last tensors: a per-channel
    negative slope, 0.25 at init; max(x, 0) + a min(x, 0)."""

    def __init__(self, channels):
        super().__init__(num_parameters=channels, init=0.25)

    def forward(self, x):
        return x.clamp_min(0) + self.weight.to(x.dtype) * x.clamp_max(0)


class Deconv2d(nn.ConvTranspose2d):
    """torch.nn.ConvTranspose2d(in, out, k, stride, padding,
    output_padding) on NHWC tensors: out = (in - 1) stride - 2 padding + k
    + output_padding. Its weight is torch's (in, out, k, k)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding=0,
                 output_padding=0, bias=True):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, output_padding=output_padding, bias=bias)

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), None,
                               self.stride, self.padding, self.output_padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y.permute(0, 2, 3, 1).contiguous()


def avg_pool(x, window, stride=None):
    """torch.nn.AvgPool2d(window, stride) on NHWC (no padding)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride or window)
    return y.permute(0, 2, 3, 1).contiguous()


def resize_nearest(x, out_hw):
    """Nearest resize of NHWC to (H, W) as the JAX package's
    ``jax.image.resize(method="nearest")``: the source of output pixel i
    is floor((i + 0.5) in / out), torch's "nearest-exact". Its docstring
    names F.interpolate's "nearest" (floor(i in / out)), which picks the
    same pixels only when out is a whole multiple of in."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="nearest-exact")
    return y.permute(0, 2, 3, 1).contiguous()


def _bicubic_matrix(n_in, n_out, align_corners):
    """(n_out, n_in) torch-bicubic (a = -0.75, edge clamp) interpolation
    matrix of one axis, in float64, as the JAX package builds it."""
    dst = np.arange(n_out, dtype=np.float64)
    if align_corners and n_out > 1:
        src = dst * (n_in - 1) / (n_out - 1)
    else:
        src = (dst + 0.5) * n_in / n_out - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((n_out, n_in))
    for kk in range(-1, 3):
        idx = np.clip(base + kk, 0, n_in - 1)
        np.add.at(mat, (np.arange(n_out), idx), _cubic_torch(frac - kk))
    return mat


def make_torch_bicubic(in_hw, out_hw, align_corners=False, device=None):
    """The counterpart of the JAX package's ``make_torch_bicubic_jax``: a
    function resizing NHWC tensors of spatial size ``in_hw`` to
    ``out_hw`` as F.interpolate(mode="bicubic", align_corners=...) does,
    as one (out, in) matrix product per axis, the matrices f32 on
    ``device`` (the card unless ``device="cpu"``) and cast to the input's
    dtype."""
    dev = resolve_device(device)
    mh = torch.tensor(_bicubic_matrix(in_hw[0], out_hw[0], align_corners), dtype=torch.float32,
                      device=dev)
    mw = torch.tensor(_bicubic_matrix(in_hw[1], out_hw[1], align_corners), dtype=torch.float32,
                      device=dev)

    def resize(x):
        y = torch.einsum("oh,bhwc->bowc", mh.to(x.dtype), x)
        return torch.einsum("pw,bowc->bopc", mw.to(x.dtype), y)

    return resize


# ---------------------------------------------------------------------------
# 3-D convs (MCNet, the 3-D GAN): NDHWC, optional weight normalisation


def _weight_norm(conv):
    """Replace ``conv.weight`` by ``weight_v`` (its direction, the weight
    as it was) and ``weight_g`` (the norm over every axis but 0, kept as
    (n, 1, ...)): torch.nn.utils.weight_norm over dim 0, which is the
    output channel of a conv and the input channel of a transposed conv."""
    v = conv.weight.detach()
    del conv.weight
    conv.weight_v = nn.Parameter(v.clone())
    conv.weight_g = nn.Parameter(v.pow(2).sum(tuple(range(1, v.ndim)), keepdim=True).sqrt())


def _weight(conv):
    """The layer's weight: g v / |v| (|v| over every axis but 0, 1e-12
    under the root, as the JAX package's ``_wn_kernel``) when weight-normed."""
    if not conv.weight_norm:
        return conv.weight
    v = conv.weight_v
    norm = (v.pow(2).sum(tuple(range(1, v.ndim)), keepdim=True) + _WN_EPS).sqrt()
    return v / norm * conv.weight_g


def _to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_ndhwc(y):
    return y.permute(0, 2, 3, 4, 1).contiguous()


class Conv3d(nn.Conv3d):
    """torch.nn.Conv3d on NDHWC tensors (D: the spectral depth), padding
    k // 2 per axis unless given, optionally weight-normed."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=None,
                 bias=True, weight_norm=False):
        kernel_size = tuple(kernel_size)
        padding = tuple(k // 2 for k in kernel_size) if padding is None else tuple(padding)
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding,
                         bias=bias)
        self.weight_norm = weight_norm
        if weight_norm:
            _weight_norm(self)

    def forward(self, x):
        y = F.conv3d(_to_ncdhw(x), _weight(self).to(x.dtype), None, self.stride, self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None, None]
        return _to_ndhwc(y)


class Deconv3d(nn.ConvTranspose3d):
    """torch.nn.ConvTranspose3d on NDHWC tensors, optionally weight-normed
    (over its input channels, torch's dim 0 of a transposed conv)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, bias=True,
                 weight_norm=False):
        super().__init__(in_channels, out_channels, tuple(kernel_size), stride=tuple(stride),
                         padding=tuple(padding), bias=bias)
        self.weight_norm = weight_norm
        if weight_norm:
            _weight_norm(self)

    def forward(self, x):
        y = F.conv_transpose3d(_to_ncdhw(x), _weight(self).to(x.dtype), None, self.stride,
                               self.padding)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None, None]
        return _to_ndhwc(y)
