"""Device-resident training scenes: upload once, sample on the card.

Port of ``hsi_dmgasr_tpu/data/device_cache.py``. The min-max-normalised
scene stack (S, H, W, C) lives in device memory, and each step's batch
of HR crops is drawn there: scene, row, col and one of the 8 augment
modes per item from a card generator, then one gather that crops and
augments. Degradation then happens on the card too
(``pipeline.train_step_from_hr``), so nothing crosses from the host per
step.

The modes are ``utils.augment.data_augmentation``'s (reference
utils.py:3-27): ccw rot90 over (H, W) with k = mode // 2, plus flipud on
odd modes. Each mode's source-index map is made by applying
``data_augmentation`` itself to the crop's index grids, so the gather
has its exact semantics. The draw order differs from the host dataset's
visit-seeded numpy RNG; the marginal distribution (uniform scene x
uniform valid crop x uniform mode) is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..utils.augment import data_augmentation


def augment_index(size):
    """(8, 2, size, size) int64: for each mode, the (row, col) of the
    source pixel of every output pixel of a square (size, size) crop."""
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    return np.stack([np.stack([data_augmentation(ii, m), data_augmentation(jj, m)])
                     for m in range(8)]).astype(np.int64)


def augment_device(x, mode):
    """torch twin of ``data_augmentation`` on a square (H, H, C) tensor."""
    si, sj = torch.as_tensor(augment_index(x.shape[0])[mode], device=x.device)
    return x[si, sj]


class DeviceSceneCache:
    """Normalised scene stack in device memory + batch sampler.

    ``scenes``: list of (H, W, C) float32 arrays, already per-scene
    min-max normalised (``HSTrainingData._scene`` provides exactly this).
    All scenes must share one shape: mixed-size corpora stay on the host
    path. ``device`` defaults to CUDA and raises without it.
    """

    def __init__(self, scenes, gt_size, device=None):
        shapes = {s.shape for s in scenes}
        if len(shapes) != 1:
            raise ValueError(
                f"device-resident sampling needs uniform scene shapes, got {sorted(shapes)}")
        h, w, _ = next(iter(shapes))
        if gt_size > min(h, w):
            raise ValueError(f"gt_size {gt_size} exceeds scene extent {(h, w)}")
        self.device = resolve_device(device)
        self.gt_size = int(gt_size)
        self.n_scenes = len(scenes)
        self.scenes = torch.stack([
            torch.as_tensor(np.ascontiguousarray(s, dtype=np.float32), device=self.device)
            for s in scenes])
        self._index = torch.as_tensor(augment_index(self.gt_size), device=self.device)

    def sample(self, generator, batch_size):
        """(batch_size, gt_size, gt_size, C) HR crops on the device, drawn
        from ``generator`` (a generator of the cache's device)."""
        S, H, W, _ = self.scenes.shape
        kw = dict(generator=generator, device=self.device)
        idx = torch.randint(0, S, (batch_size,), **kw)
        row = torch.randint(0, H - self.gt_size + 1, (batch_size,), **kw)
        col = torch.randint(0, W - self.gt_size + 1, (batch_size,), **kw)
        mode = torch.randint(0, 8, (batch_size,), **kw)
        src = self._index[mode]  # (B, 2, gt, gt)
        return self.scenes[idx[:, None, None], row[:, None, None] + src[:, 0],
                           col[:, None, None] + src[:, 1]]

    @classmethod
    def from_dataset(cls, ds, gt_size, device=None):
        """Build from an HSTrainingData-style dataset (reuses its scene
        loading, per-scene min-max normalisation and cache)."""
        scenes = [ds._scene(i) for i in range(len(ds.image_files))]
        return cls(scenes, gt_size, device=device)
