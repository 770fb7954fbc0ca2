"""Generic HSI scene datasets (reference GAE/data.py, GAE/reading_data.py):
a copy of ``hsi_dmgasr_tpu/data/scenes.py``.

``ICVLTiles``, the LoadData tiler (GAE/data.py:24-84): a stacked-scene
.npy (N, C, H, W) is normalised by 2^16 - 1, tiled into fixed HR patches
inside an edge margin of s + 6, and paired with torch-bicubic
(align_corners=True) LR downsamples.

``HyperXPatches``, a simplified HyperX (GAE/reading_data.py:40-120):
per-pixel patches of a labelled scene with ignored labels masked out and
optional flips drawn from an explicit ``np.random.RandomState``.

Items are numpy, HWC float32.
"""

from __future__ import annotations

import numpy as np

from .interp import torch_bicubic_resize


class ICVLTiles:
    def __init__(self, path, s=4, fis=144, normalize=2 ** 16 - 1):
        data = np.load(path).astype(np.float32) / normalize  # (N, C, H, W)
        n, c, hh, ww = data.shape
        margin = s + 6
        tiles = [data[i, :, x:x + fis, y:y + fis]
                 for i in range(n)
                 for x in range(margin, hh - margin - fis, fis)
                 for y in range(margin, ww - margin - fis, fis)]
        self.HR = np.stack(tiles).transpose(0, 2, 3, 1)  # CHW -> HWC
        self.LR = torch_bicubic_resize(self.HR, (fis // s, fis // s), align_corners=True)

    def __len__(self):
        return self.HR.shape[0]

    def __getitem__(self, index):
        return self.LR[index], self.HR[index]


class HyperXPatches:
    """Per-pixel patches of a labelled scene, fully supervised."""

    def __init__(self, data, gt, patch_size=5, ignored_labels=(0,), flip_augmentation=False,
                 rng=None):
        self.data = np.asarray(data, np.float32)  # (H, W, C)
        self.label = np.asarray(gt)
        self.patch_size = patch_size
        self.flip_augmentation = flip_augmentation
        self.rng = rng if rng is not None else np.random.RandomState()

        mask = np.ones_like(self.label)
        for label in ignored_labels:
            mask[self.label == label] = 0
        xs, ys = np.nonzero(mask)
        p = patch_size // 2
        keep = ((xs > p) & (xs < self.data.shape[0] - p)
                & (ys > p) & (ys < self.data.shape[1] - p))
        self.indices = np.stack([xs[keep], ys[keep]], 1)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        x, y = self.indices[i]
        p = self.patch_size // 2
        patch = self.data[x - p:x + p + 1, y - p:y + p + 1]
        if self.flip_augmentation:
            if self.rng.random() > 0.5:
                patch = patch[:, ::-1]
            if self.rng.random() > 0.5:
                patch = patch[::-1, :]
        return np.ascontiguousarray(patch), self.label[x, y]
