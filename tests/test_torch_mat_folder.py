"""The port's .mat-pair datasets and torch-style bicubic against the JAX
package, on .mat files the test writes, and stage 2's mat_pairs datatypes.

Both packages run the same numpy code, so items are held equal exactly;
the bicubic against its torch golden at atol 5e-7 (tests/test_data.py's)."""

import os

import numpy as np
import pytest
import scipy.io as sio

from hsi_dmgasr_tpu.data import interp as j_interp
from hsi_dmgasr_tpu.data import mat_folder as j_mat_folder
from hsi_dmgasr_tpu_torch.data import interp, mat_folder
from hsi_dmgasr_tpu_torch.train import stage2_driver

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_bicubic_golden.npz")


@pytest.mark.parametrize("name", ["up4", "up8", "odd"])
def test_torch_bicubic_matches_golden_and_jax(name):
    g = np.load(GOLDEN)
    x = g[f"{name}__in"]
    s = int(g[f"{name}__scale"][0])
    out = interp.torch_bicubic_resize(x, (x.shape[0] * s, x.shape[1] * s))
    np.testing.assert_allclose(out, g[f"{name}__out"], atol=5e-7)
    np.testing.assert_array_equal(
        out, j_interp.torch_bicubic_resize(x, (x.shape[0] * s, x.shape[1] * s)))


def test_torch_bicubic_batched_and_align_corners_match_jax():
    x = np.random.RandomState(0).rand(2, 5, 7, 3).astype(np.float32)
    for kw in ({}, {"align_corners": True}):
        np.testing.assert_array_equal(interp.torch_bicubic_resize(x, (11, 9), **kw),
                                      j_interp.torch_bicubic_resize(x, (11, 9), **kw))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Two training pairs ('lr'/'hr', CHW, LR 12^2 for x2) and two test
    pairs ('LR'/'HR', HWC, LR 20^2, larger than the crops)."""
    root = tmp_path_factory.mktemp("mat_pairs")
    rng = np.random.RandomState(0)
    for sub in ("train", "test"):
        os.makedirs(root / sub)
    for i in range(2):
        sio.savemat(root / "train" / f"p{i}.mat",
                    {"lr": rng.rand(5, 12, 12).astype(np.float32),
                     "hr": rng.rand(5, 24, 24).astype(np.float32)})
        sio.savemat(root / "test" / f"p{i}.mat",
                    {"LR": rng.rand(20, 20, 5).astype(np.float32),
                     "HR": rng.rand(40, 40, 5).astype(np.float32)})
    (root / "train" / "notes.txt").write_text("not a .mat")
    return root


def _same_items(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        a, b = got[i], want[i]
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            a, b = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("preload", [False, True])
def test_trainset_from_folder_matches_jax(pairs, preload):
    got = mat_folder.TrainsetFromFolder(str(pairs / "train"), scale=2, preload=preload)
    _same_items(got, j_mat_folder.TrainsetFromFolder(str(pairs / "train"), scale=2))
    item = got[0]
    assert (item["LR"].shape, item["HR"].shape, item["SR"].shape) == \
        ((12, 12, 5), (24, 24, 5), (24, 24, 5))


def test_testset_from_folder_matches_jax(pairs):
    kw = dict(scale=2, lr_size=8, hr_size=16)
    got = mat_folder.TestsetFromFolder(str(pairs / "test"), **kw)
    _same_items(got, j_mat_folder.TestsetFromFolder(str(pairs / "test"), **kw))
    assert got[1]["HR"].shape == got[1]["SR"].shape == (16, 16, 5)


def test_paired_mat_dataset_matches_jax(pairs):
    got = mat_folder.PairedMatDataset(str(pairs / "train"))
    _same_items(got, j_mat_folder.PairedMatDataset(str(pairs / "train")))
    got = mat_folder.PairedMatDataset(str(pairs / "test"), keys=("LR", "HR"), chw=False)
    _same_items(got, j_mat_folder.PairedMatDataset(str(pairs / "test"), keys=("LR", "HR"),
                                                   chw=False))


def test_stage2_builds_the_mat_pair_datatypes(pairs):
    train = stage2_driver.build_dataset(
        {"datatype": "mat_pairs_train", "dataroot": str(pairs / "train"), "n_scale": 2},
        "train")
    _same_items(train, j_mat_folder.TrainsetFromFolder(str(pairs / "train"), scale=2))
    test = stage2_driver.build_dataset(
        {"datatype": "mat_pairs_test", "dataroot": str(pairs / "test"), "l_resolution": 8,
         "r_resolution": 16}, "val", n_scale=2)
    _same_items(test, j_mat_folder.TestsetFromFolder(str(pairs / "test"), scale=2, lr_size=8,
                                                     hr_size=16))
