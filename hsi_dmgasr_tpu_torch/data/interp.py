"""torch-style bicubic interpolation (a=-0.75, align_corners=False): a
copy of ``hsi_dmgasr_tpu/data/interp.py``.

The reference uses TWO different bicubics: MATLAB imresize (a=-0.5,
antialiased; HStrain.py:61-63) and torch ``F.interpolate(mode='bicubic')``
(a=-0.75, no antialias; sr_gae.py:70/118, eval_hsi.py:312). This module
reproduces the torch one so the .mat-pair data path
(Trainset/TestsetFromFolder) is bit-comparable.

Sampling: src = (dst + 0.5) / scale - 0.5, 4-tap cubic, edge clamp.
"""

from __future__ import annotations

import numpy as np


def _cubic_torch(x, a=-0.75):
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax ** 3
    w = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    return w


def _axis_matrix(in_len, out_len, align_corners=False):
    """Dense (out, in) interpolation matrix for one axis."""
    scale = out_len / in_len
    dst = np.arange(out_len, dtype=np.float64)
    if align_corners and out_len > 1:
        src = dst * (in_len - 1) / (out_len - 1)
    else:
        src = (dst + 0.5) / scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_len, in_len), dtype=np.float64)
    for k in range(-1, 3):
        idx = np.clip(base + k, 0, in_len - 1)
        w = _cubic_torch(frac - k)
        np.add.at(mat, (np.arange(out_len), idx), w)
    return mat


def torch_bicubic_resize(x, out_hw, align_corners=False):
    """Resize (H, W, C) or (B, H, W, C) to out_hw=(H', W') torch-style."""
    x = np.asarray(x, dtype=np.float64)
    squeeze = x.ndim == 3
    if squeeze:
        x = x[None]
    b, h, w, c = x.shape
    mh = _axis_matrix(h, out_hw[0], align_corners)
    mw = _axis_matrix(w, out_hw[1], align_corners)
    y = np.einsum("oh,bhwc->bowc", mh, x)
    y = np.einsum("pw,bowc->bopc", mw, y)
    y = y.astype(np.float32)
    return y[0] if squeeze else y
