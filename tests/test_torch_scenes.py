"""The port's scene datasets (``hsi_dmgasr_tpu_torch/data/scenes.py``)
against the JAX package's, item by item, on seeded data: ``ICVLTiles``
(normalised by 2^16 - 1, the margin tiling, the align-corners bicubic LR)
exactly, and ``HyperXPatches`` (ignored labels, the border, flips drawn
from an explicit ``np.random.RandomState``) exactly."""

import numpy as np
import pytest

from hsi_dmgasr_tpu.data import scenes as jscenes
from hsi_dmgasr_tpu_torch.data import scenes


@pytest.mark.parametrize("s,fis", [(4, 16), (2, 12)])
def test_icvl_tiles_match_jax(tmp_path, s, fis):
    data = tmp_path / "scenes.npy"
    np.save(data, (np.random.RandomState(0).rand(2, 5, 60, 47) * (2 ** 16 - 1)).astype(np.uint16))
    got, want = scenes.ICVLTiles(str(data), s=s, fis=fis), jscenes.ICVLTiles(str(data), s=s,
                                                                             fis=fis)
    assert len(got) == len(want) > 2
    for i in range(len(want)):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert got[0][0].shape == (fis // s, fis // s, 5) and got[0][1].shape == (fis, fis, 5)


@pytest.mark.parametrize("flip", [False, True])
def test_hyperx_patches_match_jax(flip):
    rng = np.random.RandomState(1)
    data, gt = rng.rand(20, 17, 6).astype(np.float32), rng.randint(0, 4, (20, 17))
    got = scenes.HyperXPatches(data, gt, patch_size=5, ignored_labels=(0, 3),
                               flip_augmentation=flip, rng=np.random.RandomState(7))
    want = jscenes.HyperXPatches(data, gt, patch_size=5, ignored_labels=(0, 3),
                                 flip_augmentation=flip, rng=np.random.RandomState(7))
    np.testing.assert_array_equal(got.indices, want.indices)
    for i in range(len(want)):
        (pa, la), (pb, lb) = got[i], want[i]
        np.testing.assert_array_equal(pa, pb)
        assert la == lb and la not in (0, 3) and pa.shape == (5, 5, 6)
