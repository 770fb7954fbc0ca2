"""SR3 face-SR dataset (data/LRHR_dataset.py rebuild): the port of
``hsi_dmgasr_tpu/data/lrhr.py``.

Three source modes:
  * 'img'  — folder-scan layout ``{root}/hr_{r}, sr_{l}_{r}[, lr_{l}]``
             (the upstream LRHR_dataset_bak.py:28-40 layout);
  * 'list' — ``list_file`` of "lr hr" path pairs with random 128^2 crops
             (the modified LRHR_dataset.py:40-52 mode), the SR made by the
             torch-style bicubic of ``data/interp.py``;
  * 'lmdb' — standard SR3 lmdb databases (prepare_data.py:83-92 key
             scheme), read by the dependency-free ``io/lmdb_lite`` reader.

Values are HWC float32 numpy arrays scaled to min_max (default (-1, 1)),
with the reference's paired random hflip at train time
(data/util.py:74-83), drawn from the dataset's numpy ``rng``. PNG and
JPEG decoding needs PIL, imported when an item is read.
"""

from __future__ import annotations

import io
import os

import numpy as np

from .interp import torch_bicubic_resize


def _png_paths(d):
    exts = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")
    out = []
    for dirpath, _, fnames in sorted(os.walk(d)):
        for f in sorted(fnames):
            if f.lower().endswith(exts):
                out.append(os.path.join(dirpath, f))
    return out


def _to_float(img, min_max=(-1, 1)):
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr * (min_max[1] - min_max[0]) + min_max[0]


def _decode(src):
    """An image file path or its encoded bytes -> (H, W, 3) uint8."""
    from PIL import Image

    if isinstance(src, bytes):
        src = io.BytesIO(src)
    with Image.open(src) as img:
        return np.asarray(img.convert("RGB"))


class LRHRDataset:
    def __init__(self, dataroot, datatype="img", l_resolution=16,
                 r_resolution=128, split="train", data_len=-1, need_LR=False,
                 list_file=None, min_max=(-1, 1), rng=None):
        self.dataroot = dataroot
        self.datatype = datatype
        self.l_res = l_resolution
        self.r_res = r_resolution
        self.split = split
        self.need_LR = need_LR
        self.min_max = min_max
        self.rng = rng if rng is not None else np.random.RandomState()

        if datatype == "img":
            self.hr_path = _png_paths(os.path.join(dataroot, f"hr_{r_resolution}"))
            self.sr_path = _png_paths(os.path.join(dataroot, f"sr_{l_resolution}_{r_resolution}"))
            self.lr_path = (_png_paths(os.path.join(dataroot, f"lr_{l_resolution}"))
                            if need_LR else None)
            self.dataset_len = len(self.hr_path)
        elif datatype == "list":
            with open(os.path.join(dataroot, list_file)) as f:
                self.pairs = [ln.rstrip().split(" ") for ln in f if ln.strip()]
            self.dataset_len = len(self.pairs)
        elif datatype == "lmdb":
            from ..io.lmdb_lite import LmdbReader

            self.env = LmdbReader(dataroot)
            length = self.env.get(b"length")
            self.dataset_len = int(length) if length is not None else len(self.env)
        else:
            raise NotImplementedError(f"data_type [{datatype}]")

        self.data_len = (self.dataset_len if data_len is None or data_len <= 0
                         else min(data_len, self.dataset_len))

    def __len__(self):
        return self.data_len

    def _augment(self, imgs):
        if self.split == "train" and self.rng.rand() < 0.5:
            imgs = [np.ascontiguousarray(im[:, ::-1]) for im in imgs]
        return imgs

    def _lmdb_image(self, key):
        raw = self.env.get(key)
        if raw is None:
            raise KeyError(f"lmdb {self.dataroot} has no entry {key}")
        return _decode(raw)

    def __getitem__(self, index):
        if self.datatype == "lmdb":
            # the reference key scheme: data/prepare_data.py:83-92
            img_HR = self._lmdb_image(f"hr_{self.r_res}_{index:05d}")
            img_SR = self._lmdb_image(f"sr_{self.l_res}_{self.r_res}_{index:05d}")
            img_LR = (self._lmdb_image(f"lr_{self.l_res}_{index:05d}")
                      if self.need_LR else None)
        elif self.datatype == "img":
            img_HR = _decode(self.hr_path[index])
            img_SR = _decode(self.sr_path[index])
            img_LR = _decode(self.lr_path[index]) if self.need_LR else None
        else:  # list
            lr_rel, hr_rel = self.pairs[index]
            img_LR = _decode(os.path.join(self.dataroot, lr_rel))
            img_HR = _decode(os.path.join(self.dataroot, hr_rel))
            img_SR = np.clip(torch_bicubic_resize(img_LR.astype(np.float32),
                                                  (img_HR.shape[0], img_HR.shape[1])), 0, 255)
            x = self.rng.randint(0, img_HR.shape[1] - 128)
            y = self.rng.randint(0, img_HR.shape[0] - 128)
            img_HR = img_HR[y:y + 128, x:x + 128]
            img_SR = img_SR[y:y + 128, x:x + 128]
            if not self.need_LR:
                img_LR = None

        if self.need_LR:
            lr, sr, hr = self._augment([img_LR, img_SR, img_HR])
            return {"LR": _to_float(lr, self.min_max), "SR": _to_float(sr, self.min_max),
                    "HR": _to_float(hr, self.min_max), "Index": index}
        sr, hr = self._augment([img_SR, img_HR])
        return {"SR": _to_float(sr, self.min_max), "HR": _to_float(hr, self.min_max),
                "Index": index}
