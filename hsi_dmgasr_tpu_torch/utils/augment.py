"""Geometric augmentation (a copy of ``hsi_dmgasr_tpu/utils/augment.py``'s
``data_augmentation``).

The reference's 8-way flip/rotation encoding (utils.py:3-27): mode 0
identity; odd modes add an up-down flip on top of rot90 multiples; modes
{0,2,4,6} are pure ccw rotations of k={0,1,2,3}.
"""

from __future__ import annotations

import numpy as np


def data_augmentation(label, mode=0):
    """8-way flip/rot on an (H, W, ...) array. Matches utils.py:3-27."""
    if mode == 0:
        return label
    if mode == 1:
        return np.flipud(label)
    if mode == 2:
        return np.rot90(label)
    if mode == 3:
        return np.flipud(np.rot90(label))
    if mode == 4:
        return np.rot90(label, k=2)
    if mode == 5:
        return np.flipud(np.rot90(label, k=2))
    if mode == 6:
        return np.rot90(label, k=3)
    if mode == 7:
        return np.flipud(np.rot90(label, k=3))
    raise ValueError(f"invalid augmentation mode {mode}")
