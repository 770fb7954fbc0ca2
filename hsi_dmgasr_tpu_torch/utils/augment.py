"""Geometric augmentation: a copy of ``hsi_dmgasr_tpu/utils/augment.py``.

``data_augmentation`` is the reference's 8-way flip/rotation encoding
(utils.py:3-27): mode 0 identity; odd modes add an up-down flip on top of
rot90 multiples; modes {0,2,4,6} are pure ccw rotations of k={0,1,2,3}.

``paired_random_augment`` is the SR3 face-data path (data/util.py:27-44):
random hflip/vflip/rot applied consistently across an (LR, HR, ...) tuple.
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


def paired_random_augment(img_list, rng, hflip=True, rot=True, train=True):
    """Random hflip/vflip/rot90 applied consistently to a list of HWC
    arrays (the SR3 face-data path, data/util.py:27-44), the three draws
    taken from the numpy ``rng`` in that order."""
    do_h = hflip and train and rng.random() < 0.5
    do_v = rot and train and rng.random() < 0.5
    do_r = rot and train and rng.random() < 0.5

    def _aug(img):
        if do_h:
            img = img[:, ::-1, :]
        if do_v:
            img = img[::-1, :, :]
        if do_r:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [_aug(img) for img in img_list]
