"""MATLAB-compatible ``imresize`` (antialiased bicubic/bilinear).

A copy of the numpy half of ``hsi_dmgasr_tpu/data/imresize.py``: the LR
degradation, bit-accurate with the reference's port of MATLAB's imresize
(``imsize.py:116-158``) for PSNR parity:

  * cubic kernel with a=-0.5; when downscaling, the kernel is stretched
    for antialiasing: ``h(x) = s * k(s*x)`` with support ``4/s``.
  * sample positions ``u = (x+1)/s + 0.5*(1 - 1/s)`` (1-based MATLAB x).
  * mirrored boundary handling via the [0..n-1, n-1..0] reflection trick.
  * per-row weight normalization, zero-weight column pruning.
  * dims are processed in order of increasing scale factor.

``make_imresize_torch`` is the on-device form of the JAX package's
``make_imresize_jax`` for a static input shape: each dimension's weighted
gather becomes a contraction with f32 weights, computed in true f32
whatever torch's TF32 flags say (the degradation defines PSNR parity).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device


def cubic(x):
    """MATLAB bicubic kernel (a = -0.5). Matches imsize.py:25-32."""
    x = np.asarray(x, dtype=np.float64)
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
    outer = (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2))
    return inner + outer


def triangle(x):
    """Bilinear kernel. Matches imsize.py:17-22."""
    x = np.asarray(x, dtype=np.float64)
    return (x + 1.0) * ((x >= -1) & (x < 0)) + (1.0 - x) * ((x >= 0) & (x <= 1))


_KERNELS = {"bicubic": (cubic, 4.0), "bilinear": (triangle, 2.0)}


def _contributions(in_length, out_length, scale, kernel, k_width):
    """Weight/index tables for one dimension (imsize.py:35-59 semantics)."""
    if scale < 1:
        def h(x):
            return scale * kernel(scale * x)

        kernel_width = k_width / scale
    else:
        h = kernel
        kernel_width = k_width

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    P = int(math.ceil(kernel_width)) + 2
    # 0-based candidate source indices per output sample
    ind = left[:, None] + np.arange(P) - 1
    indices = ind.astype(np.int64)
    weights = h(u[:, None] - indices - 1)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # mirror boundary: indices reflected into [0, in_length)
    aux = np.concatenate(
        (np.arange(in_length), np.arange(in_length - 1, -1, -1))
    ).astype(np.int64)
    indices = aux[np.mod(indices, aux.size)]
    # prune columns that contribute nothing for any output sample
    keep = np.nonzero(np.any(weights != 0, axis=0))[0]
    return weights[:, keep], indices[:, keep]


def _resize_along_dim(A, dim, weights, indices):
    """Apply one dim's weighted gather: out[o] = sum_p w[o,p] * A[idx[o,p]]."""
    gathered = np.take(A, indices, axis=dim).astype(np.float64)
    # gathered has shape A.shape[:dim] + (out, P) + A.shape[dim+1:]
    w = weights.reshape((1,) * dim + weights.shape + (1,) * (A.ndim - dim - 1))
    return np.sum(gathered * w, axis=dim + 1)


def resize_plan(in_shape, scalar_scale=None, output_shape=None, method="bicubic"):
    """Compute (output_size, per-dim (dim, weights, indices) apply order)."""
    kernel, k_width = _KERNELS[method]
    if (scalar_scale is None) == (output_shape is None):
        raise ValueError("exactly one of scalar_scale / output_shape required")
    if scalar_scale is not None:
        s = float(scalar_scale)
        scale = [s, s]
        output_size = [int(math.ceil(s * in_shape[k])) for k in range(2)]
    else:
        output_size = list(output_shape)
        scale = [output_size[k] / in_shape[k] for k in range(2)]

    tables = []
    for k in range(2):
        w, ind = _contributions(in_shape[k], output_size[k], scale[k], kernel, k_width)
        tables.append((w, ind))
    order = np.argsort(np.array(scale), kind="stable")
    plan = [(int(d), tables[d][0], tables[d][1]) for d in order]
    return output_size, plan


def imresize(I, scalar_scale=None, method="bicubic", output_shape=None):
    """MATLAB-compatible resize of an (H, W) or (H, W, C) array.

    Drop-in equivalent of the reference ``imresize`` (imsize.py:116-158):
    float inputs pass through in float64; uint8 is clipped+rounded.
    """
    I = np.asarray(I)
    _, plan = resize_plan(I.shape[:2], scalar_scale, output_shape, method)
    B = I
    squeeze = False
    if B.ndim == 2:
        B = B[:, :, None]
        squeeze = True
    for dim, w, ind in plan:
        B = _resize_along_dim(B, dim, w, ind)
        # MATLAB (and the reference, imsize.py:101-105) quantizes uint8
        # after EVERY dimension pass, not only at the end.
        if I.dtype == np.uint8:
            B = np.around(np.clip(B, 0, 255)).astype(np.uint8)
    if squeeze:
        B = B[:, :, 0]
    return B


def make_imresize_torch(in_shape, scalar_scale=None, output_shape=None, method="bicubic",
                        device=None):
    """A resize fn for a static (H, W) input spatial shape on ``device``
    (CUDA unless the caller asks for the CPU; raises without CUDA).

    Returns ``f(x)`` on (..., H, W, C) f32 tensors (spatial dims at -3/-2).
    Each dimension is the contraction of ``make_imresize_jax``'s dense
    (out, in) f32 matrix, restricted to its nonzero taps: a gather of the
    P source rows of every output row, a multiply by their f32 weights
    and a sum over P. No matmul runs, so TF32 cannot enter; the dense
    matrix's zeros would add nothing. Matches the numpy ``imresize`` to
    about 1e-6 (f32).
    """
    dev = resolve_device(device)
    _, plan = resize_plan(in_shape, scalar_scale, output_shape, method)
    taps = [(dim, torch.tensor(w, dtype=torch.float32, device=dev),
             torch.tensor(ind, dtype=torch.int64, device=dev)) for dim, w, ind in plan]

    def f(x):
        for dim, w, ind in taps:
            axis = x.ndim - 3 + dim
            g = x.index_select(axis, ind.reshape(-1)).unflatten(axis, tuple(ind.shape))
            x = (g * w.reshape(w.shape + (1,) * (x.ndim - axis - 1))).sum(axis + 1)
        return x

    return f
