"""Overlapping band groups of the grouped SR models (SSPSR, GELIN,
CEGATSR): the groups folded into the batch, so a shared branch runs once,
and the branch outputs overlap-averaged back into the cube by one
``index_add_`` over the band axis divided by each band's count, as
``models/gae.py`` does."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..gae import group_indices


class BandGroups(nn.Module):
    """The (G, n_subs) band table of ``group_indices`` and each band's
    count, as buffers that no state_dict holds."""

    def __init__(self, n_colors, n_subs, n_ovls):
        super().__init__()
        idx = group_indices(n_colors, n_subs, n_ovls)
        self.G, self.n_subs, self.n_colors = idx.shape[0], n_subs, n_colors
        self.starts = [int(i) for i in idx[:, 0]]
        counts = np.zeros(n_colors, dtype=np.float32)
        np.add.at(counts, idx.reshape(-1), 1.0)
        self.register_buffer("idx", torch.from_numpy(idx.reshape(-1)), persistent=False)
        self.register_buffer("counts", torch.from_numpy(counts), persistent=False)

    def fold(self, x):
        """(B, h, w, C) -> (B*G, h, w, n_subs), the groups of each item in order."""
        b, h, w, _ = x.shape
        xg = x.index_select(-1, self.idx).reshape(b, h, w, self.G, self.n_subs)
        return xg.permute(0, 3, 1, 2, 4).reshape(b * self.G, h, w, self.n_subs)

    def merge(self, yg, b):
        """(B*G, H, W, n_subs) -> (B, H, W, C): the groups scattered back to
        their bands and averaged over the overlaps."""
        _, hh, ww, _ = yg.shape
        yg = yg.reshape(b, self.G, hh, ww, self.n_subs).permute(0, 2, 3, 1, 4)
        yg = yg.reshape(b, hh, ww, self.G * self.n_subs)
        y = yg.new_zeros((b, hh, ww, self.n_colors)).index_add_(-1, self.idx, yg)
        return y / self.counts.to(yg.dtype)
