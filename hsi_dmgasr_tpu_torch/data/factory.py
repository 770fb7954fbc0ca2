"""Dataset/dataloader factory matching the reference config schema
(data/__init__.py:7-40): the port of ``hsi_dmgasr_tpu/data/factory.py``
on the port's ``data/loader.py``."""

from __future__ import annotations

from .loader import DataLoader
from .lrhr import LRHRDataset


def create_dataset(dataset_opt, phase):
    """LRHR dataset from a config 'datasets' entry (data/__init__.py:24-40)."""
    return LRHRDataset(
        dataroot=dataset_opt["dataroot"],
        datatype=dataset_opt["datatype"],
        l_resolution=dataset_opt["l_resolution"],
        r_resolution=dataset_opt["r_resolution"],
        split=phase,
        data_len=dataset_opt["data_len"],
        need_LR=dataset_opt["mode"] == "LRHR",
        list_file=dataset_opt.get("list_file"),
    )


def create_dataloader(dataset, dataset_opt, phase):
    """Train/val loader split (data/__init__.py:7-22)."""
    if phase == "train":
        return DataLoader(dataset, batch_size=dataset_opt["batch_size"],
                          shuffle=bool(dataset_opt.get("use_shuffle", True)))
    if phase == "val":
        return DataLoader(dataset, batch_size=1, shuffle=False)
    raise NotImplementedError(f"Dataloader [{phase}] is not found.")
