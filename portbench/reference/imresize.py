"""MATLAB's ``imresize`` (bicubic, a = -0.5, antialiased when shrinking) in
plain PyTorch, as dense per-dimension matrices: the degradation of
DMGASR's training pairs (the reference's ``imsize.py``: sample positions
u = x / s + 0.5 (1 - 1/s), the kernel stretched by 1/s when s < 1, mirrored
edges, rows normalised to sum 1; the dimensions resized in the order of
their scale factors)."""

from __future__ import annotations

import math

import numpy as np
import torch


def _cubic(x):
    ax = np.abs(x)
    return ((1.5 * ax ** 3 - 2.5 * ax ** 2 + 1.0) * (ax <= 1)
            + (-0.5 * ax ** 3 + 2.5 * ax ** 2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2)))


def matrix(n_in, n_out):
    """(n_out, n_in) float64 weights of one dimension."""
    s = n_out / n_in
    width = 4.0 / s if s < 1 else 4.0
    x = np.arange(1, n_out + 1, dtype=np.float64)
    u = x / s + 0.5 * (1.0 - 1.0 / s)
    left = np.floor(u - width / 2.0)
    taps = left[:, None] + np.arange(int(math.ceil(width)) + 2) - 1
    w = (s * _cubic(s * (u[:, None] - taps - 1)) if s < 1 else _cubic(u[:, None] - taps - 1))
    w = w / w.sum(1, keepdims=True)
    mirror = np.concatenate([np.arange(n_in), np.arange(n_in - 1, -1, -1)])
    src = mirror[np.mod(taps.astype(np.int64), mirror.size)]
    m = np.zeros((n_out, n_in))
    for i in range(n_out):
        np.add.at(m[i], src[i], w[i])
    return m


def resize(x, out_hw):
    """x (B, H, W, C) float32 -> (B, out_h, out_w, C)."""
    _, h, w, _ = x.shape
    scales = [out_hw[0] / h, out_hw[1] / w]
    for dim in sorted(range(2), key=lambda d: scales[d]):
        n_in = x.shape[1 + dim]
        m = torch.tensor(matrix(n_in, out_hw[dim]), dtype=x.dtype, device=x.device)
        x = torch.einsum("oh,bhwc->bowc", m, x) if dim == 0 else torch.einsum("ow,bhwc->bhoc", m, x)
    return x


def degrade(hr, scale):
    """HR crops -> bicubic-up(clip(bicubic-down)), clipped to [0, 1]."""
    h, w = hr.shape[1:3]
    lr = resize(hr, (h // scale, w // scale)).clamp(0.0, 1.0)
    return resize(lr, (h, w)).clamp(0.0, 1.0)
