"""MATLAB-preprocessed .mat pair datasets (the second reference data path,
README.md:30-33): a copy of ``hsi_dmgasr_tpu/data/mat_folder.py``.

``TrainsetFromFolder`` (sr_gae.py:80-123): .mat files with 'lr'/'hr' CHW
arrays; SR = torch-bicubic ×scale upsample of LR.
``TestsetFromFolder`` (sr_gae.py:39-77): 'LR'/'HR' HWC arrays, fixed
crops (LR 32², HR 128² in the shipped config).
``PairedMatDataset``: the (lr, hr) tuple flavor used by the stage-1
trainers (GAE/utils.py:240-284).

All outputs are HWC float32.
"""

from __future__ import annotations

import os

import numpy as np

from .interp import torch_bicubic_resize


def _mat_files(dataset_dir):
    return sorted(
        os.path.join(dataset_dir, x)
        for x in os.listdir(dataset_dir)
        if x.endswith(".mat")
    )


def _loadmat(path):
    import scipy.io as sio

    return sio.loadmat(path, verify_compressed_data_integrity=False)


class TrainsetFromFolder:
    def __init__(self, dataset_dir, scale=4, preload=False):
        self.image_filenames = _mat_files(dataset_dir)
        self.scale = scale
        self.img = [_loadmat(p) for p in self.image_filenames] if preload else None

    def __len__(self):
        return len(self.image_filenames)

    def __getitem__(self, index):
        mat = self.img[index] if self.img else _loadmat(self.image_filenames[index])
        # 'lr'/'hr' are CHW in the reference files -> HWC here
        lr = np.moveaxis(mat["lr"].astype(np.float32), 0, -1)
        hr = np.moveaxis(mat["hr"].astype(np.float32), 0, -1)
        sr = torch_bicubic_resize(
            lr, (lr.shape[0] * self.scale, lr.shape[1] * self.scale)
        )
        return {"HR": hr, "SR": sr, "LR": lr}


class TestsetFromFolder:
    def __init__(self, dataset_dir, scale=4, lr_size=32, hr_size=128,
                 preload=True):
        self.image_filenames = _mat_files(dataset_dir)
        self.scale = scale
        self.lr_size = lr_size
        self.hr_size = hr_size
        self.img = [_loadmat(p) for p in self.image_filenames] if preload else None

    def __len__(self):
        return len(self.image_filenames)

    def __getitem__(self, index):
        mat = self.img[index] if self.img else _loadmat(self.image_filenames[index])
        lr = mat["LR"].astype(np.float32)[: self.lr_size, : self.lr_size, :]
        hr = mat["HR"].astype(np.float32)[: self.hr_size, : self.hr_size, :]
        sr = torch_bicubic_resize(
            lr, (lr.shape[0] * self.scale, lr.shape[1] * self.scale)
        )
        return {"HR": hr, "SR": sr, "LR": lr}


class PairedMatDataset:
    """(lr, hr) tuples for stage-1 AE/baseline trainers."""

    def __init__(self, dataset_dir, keys=("lr", "hr"), chw=True):
        self.image_filenames = _mat_files(dataset_dir)
        self.keys = keys
        self.chw = chw

    def __len__(self):
        return len(self.image_filenames)

    def __getitem__(self, index):
        mat = _loadmat(self.image_filenames[index])
        lr = mat[self.keys[0]].astype(np.float32)
        hr = mat[self.keys[1]].astype(np.float32)
        if self.chw:
            lr = np.moveaxis(lr, 0, -1)
            hr = np.moveaxis(hr, 0, -1)
        return lr, hr
