"""Hyperspectral cube datasets (MATLAB-degradation path): a copy of
``hsi_dmgasr_tpu/data/hs_datasets.py``.

``HSTrainingData`` (HStrain.py:12-89): .mat scenes ('block' key), per-cube
min-max normalization, random 32·scale crop, MATLAB-bicubic down+up
degradation, 8-way flip/rot augmentation encoded in the index.

``HSTestData`` (HStest.py:10-72): .npy scenes, fixed top-left gt_size
crop (64 in the shipped config), same degradation.

Items are numpy dicts {'HR','SR','LR'} in HWC float32 — the framework is
NHWC-native; the reference's CHW tensors exist only at its torch boundary.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.augment import data_augmentation
from .imresize import imresize


def _minmax(img):
    return (img - img.min()) / (img.max() - img.min())


class HSTrainingData:
    def __init__(self, image_dir, n_scale, num_ch=None, augment=None,
                 ch3=False, base_size=32, rng=None, cache_scenes=True,
                 hr_only=False):
        # hr_only skips the bicubic degradation entirely — stage-1 GAE
        # training consumes only the HR crop (AE.py:582-597)
        self.hr_only = hr_only
        self.image_files = sorted(
            os.path.join(image_dir, x) for x in os.listdir(image_dir)
        )
        self.augment = augment
        self.n_scale = n_scale
        self.i = num_ch
        self.ch3 = ch3
        self.base_size = base_size
        self.factor = 8 if augment else 1
        self.rng = rng if rng is not None else np.random.RandomState()
        # crop coordinates are drawn from a per-(item, visit) seeded RNG:
        # thread-safe under num_workers > 1 (a shared RandomState is not)
        # and reproducible, while still varying across epochs
        import threading

        self._crop_seed = int(self.rng.randint(0, 2**31 - 1))
        self._visits = {}
        self._visits_lock = threading.Lock()
        # the reference re-reads + re-normalizes the full .mat scene on
        # EVERY item (HStrain.py:35-54); cache the normalized scenes once
        self._cache = {} if cache_scenes else None

    def __len__(self):
        return len(self.image_files) * self.factor

    def _load(self, path):
        import scipy.io as sio

        if path.endswith(".npy"):
            return np.load(path).astype(np.float32)
        data = sio.loadmat(path, verify_compressed_data_integrity=False)
        return np.asarray(data["block"], dtype=np.float32)

    def _scene(self, file_index):
        if self._cache is not None and file_index in self._cache:
            return self._cache[file_index]
        img = _minmax(self._load(self.image_files[file_index]))
        if self._cache is not None:
            self._cache[file_index] = img
        return img

    def __getitem__(self, index):
        file_index, aug_num = index, 0
        if self.augment:
            file_index = index // self.factor
            aug_num = int(index % self.factor)
        img = self._scene(file_index)

        height, width, _ = img.shape
        gt_size = self.base_size * self.n_scale
        with self._visits_lock:
            visit = self._visits.get(index, 0)
            self._visits[index] = visit + 1
        crop_rng = np.random.RandomState(
            np.random.SeedSequence(
                [self._crop_seed, int(index), visit]
            ).generate_state(1)[0]
        )
        row = crop_rng.randint(0, height - gt_size + 1)
        col = crop_rng.randint(0, width - gt_size + 1)
        gt = img[row:row + gt_size, col:col + gt_size, :]

        if self.hr_only:
            gt = data_augmentation(gt, mode=aug_num)
            return {"HR": np.ascontiguousarray(gt, dtype=np.float32)}

        ms = imresize(gt, output_shape=(self.base_size, self.base_size))
        lms = imresize(ms, output_shape=(gt_size, gt_size))

        ms = data_augmentation(ms, mode=aug_num)
        lms = data_augmentation(lms, mode=aug_num)
        gt = data_augmentation(gt, mode=aug_num)

        ms = np.clip(ms, 0, 1).astype(np.float32)
        lms = np.clip(lms, 0, 1).astype(np.float32)
        gt = np.ascontiguousarray(gt, dtype=np.float32)

        if self.ch3:
            sel = [self.i, self.i + 34, self.i + 68]
            gt, ms, lms = gt[..., sel], ms[..., sel], lms[..., sel]

        return {"HR": gt, "SR": lms, "LR": ms}


class HSTestData:
    def __init__(self, image_dir, n_scale, num_ch=None, ch3=False, gt_size=64):
        self.image_files = sorted(
            os.path.join(image_dir, x) for x in os.listdir(image_dir)
        )
        self.n_scale = n_scale
        self.i = num_ch
        self.ch3 = ch3
        self.gt_size = gt_size

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, index):
        path = self.image_files[index]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            import scipy.io as sio

            img = np.asarray(
                sio.loadmat(path, verify_compressed_data_integrity=False)["block"]
            )
        img = _minmax(img.astype(np.float32))

        g = self.gt_size
        gt = img[:g, :g, :]
        ms = imresize(gt, output_shape=(g // self.n_scale, g // self.n_scale))
        lms = imresize(ms, output_shape=(g, g))

        ms = np.clip(ms, 0, 1).astype(np.float32)
        lms = np.clip(lms, 0, 1).astype(np.float32)
        gt = np.ascontiguousarray(gt, dtype=np.float32)

        if self.ch3:
            x = 34
            sel = [self.i, self.i + x, self.i + 2 * x]
            gt, ms, lms = gt[..., sel], ms[..., sel], lms[..., sel]

        return {"HR": gt, "SR": lms, "LR": ms}
