"""The port's data layer against the JAX package's: MATLAB imresize
(bit-exact on the reference goldens), its on-device form, the 8 augment
modes, the device-resident scene cache (the cases of
tests/test_device_cache.py), the HSI datasets and the batch loader."""

import os

import jax
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.data.device_cache import augment_device as j_augment_device
from hsi_dmgasr_tpu.data.hs_datasets import HSTestData as JHSTestData
from hsi_dmgasr_tpu.data.hs_datasets import HSTrainingData as JHSTrainingData
from hsi_dmgasr_tpu.data.loader import DataLoader as JDataLoader
from hsi_dmgasr_tpu.utils.augment import data_augmentation as j_data_augmentation
from hsi_dmgasr_tpu_torch.data.device_cache import DeviceSceneCache, augment_device
from hsi_dmgasr_tpu_torch.data.hs_datasets import HSTestData, HSTrainingData
from hsi_dmgasr_tpu_torch.data.imresize import imresize, make_imresize_torch
from hsi_dmgasr_tpu_torch.data.loader import DataLoader
from hsi_dmgasr_tpu_torch.utils.augment import data_augmentation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's thread pool only spins against the other test
    workers of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "imresize_golden.npz")
CASES = ["down_128_32", "up_32_128", "down_64_16", "scale_half", "scale_2x", "scale_3x",
         "odd_shape", "gray_2d", "uint8"]


def _kw(arr):
    scale, h, w = arr
    if scale > 0:
        return dict(scalar_scale=float(scale))
    return dict(output_shape=(int(h), int(w)))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.mark.parametrize("name", CASES)
def test_imresize_matches_reference(golden, name):
    """As tests/test_imresize.py holds the JAX package's numpy imresize."""
    expected = golden[f"{name}__out"]
    out = imresize(golden[f"{name}__in"], **_kw(golden[f"{name}__kw"]))
    assert out.shape == expected.shape and out.dtype == expected.dtype
    if expected.dtype == np.uint8:
        np.testing.assert_array_equal(out, expected)
    else:
        np.testing.assert_allclose(out, expected, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape,out", [((2, 64, 64, 7), (16, 16)), ((3, 16, 16, 5), (64, 64)),
                                       ((24, 20, 4), (6, 5))])
def test_imresize_torch_matches_numpy(shape, out):
    """Batched NHWC and single HWC, down and up: within 1e-6 of the f64
    numpy resize, with TF32 allowed (no matmul runs)."""
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    f = make_imresize_torch(shape[-3:-1], output_shape=out, device="cpu")
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = f(torch.tensor(x)).numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    imgs = x.reshape(-1, *shape[-3:])
    want = np.stack([imresize(im, output_shape=out) for im in imgs]).reshape(got.shape)
    assert got.dtype == np.float32 and got.shape == (*shape[:-3], *out, shape[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", range(8))
def test_augment_modes(mode):
    x = np.random.RandomState(mode).rand(12, 12, 5).astype(np.float32)
    want = j_data_augmentation(x, mode=mode)
    np.testing.assert_array_equal(data_augmentation(x, mode=mode), want)
    np.testing.assert_array_equal(augment_device(torch.tensor(x), mode).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jax.jit(j_augment_device)(x, mode)), want)


def test_sampler_shapes_determinism_and_validity():
    rng = np.random.RandomState(0)
    scenes = [rng.rand(24, 24, 6).astype(np.float32) for _ in range(3)]
    cache = DeviceSceneCache(scenes, gt_size=8, device="cpu")
    a = cache.sample(torch.Generator().manual_seed(7), 4).numpy()
    b = cache.sample(torch.Generator().manual_seed(7), 4).numpy()
    assert a.shape == (4, 8, 8, 6) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    c = cache.sample(torch.Generator().manual_seed(8), 4).numpy()
    assert np.abs(a - c).max() > 0
    allvals = np.sort(np.concatenate([s.ravel() for s in scenes]))
    pos = np.clip(np.searchsorted(allvals, a.ravel()), 0, allvals.size - 1)
    assert np.allclose(allvals[pos], a.ravel())


def test_crop_is_a_window_of_an_augmented_scene():
    """Each item equals data_augmentation(scene[r:r+g, c:c+g], m) for some
    scene, row, col and mode."""
    rng = np.random.RandomState(2)
    scenes = [rng.rand(9, 11, 3).astype(np.float32) for _ in range(2)]
    cache = DeviceSceneCache(scenes, gt_size=5, device="cpu")
    for item in cache.sample(torch.Generator().manual_seed(4), 6).numpy():
        hits = sum(np.array_equal(item, data_augmentation(s[r:r + 5, c:c + 5], m))
                   for s in scenes for r in range(5) for c in range(7) for m in range(8))
        assert hits >= 1


def test_fullsize_crop_is_an_exact_augmented_scene():
    rng = np.random.RandomState(1)
    scenes = [rng.rand(10, 10, 4).astype(np.float32) for _ in range(2)]
    cache = DeviceSceneCache(scenes, gt_size=10, device="cpu")
    batch = cache.sample(torch.Generator().manual_seed(3), 6).numpy()
    for item in batch:
        assert sum(np.array_equal(item, data_augmentation(s, mode=m))
                   for s in scenes for m in range(8)) >= 1


def test_rejects_mixed_shapes_and_oversized_crop():
    a = np.zeros((8, 8, 3), np.float32)
    b = np.zeros((9, 8, 3), np.float32)
    with pytest.raises(ValueError, match="uniform"):
        DeviceSceneCache([a, b], gt_size=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        DeviceSceneCache([a], gt_size=16, device="cpu")


def test_cache_from_dataset_holds_the_normalised_scenes(synth_data):
    ds = HSTrainingData(os.path.join(synth_data, "mat_scenes"), n_scale=2, augment=True,
                        base_size=16, hr_only=True)
    cache = DeviceSceneCache.from_dataset(ds, gt_size=32, device="cpu")
    assert cache.n_scenes == 2
    jds = JHSTrainingData(os.path.join(synth_data, "mat_scenes"), n_scale=2, augment=True,
                          base_size=16, hr_only=True)
    for i in range(2):
        np.testing.assert_array_equal(cache.scenes[i].numpy(), jds._scene(i))


@pytest.mark.parametrize("hr_only", [False, True])
def test_training_data_matches_jax(synth_data, hr_only):
    """Same files, same seeded RandomState: the same crops, augment modes
    and degradations, item by item (two visits of each)."""
    root = os.path.join(synth_data, "mat_scenes")
    ds = HSTrainingData(root, n_scale=2, augment=True, base_size=16, hr_only=hr_only,
                        rng=np.random.RandomState(5))
    jds = JHSTrainingData(root, n_scale=2, augment=True, base_size=16, hr_only=hr_only,
                          rng=np.random.RandomState(5))
    assert len(ds) == len(jds) == 16
    for i in (0, 5, 11, 0, 5):
        got, want = ds[i], jds[i]
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)


def test_test_data_matches_jax(synth_data):
    root = os.path.join(synth_data, "npy_scenes")
    ds, jds = HSTestData(root, n_scale=2, gt_size=32), JHSTestData(root, n_scale=2, gt_size=32)
    assert len(ds) == len(jds)
    for i in range(len(ds)):
        for k, v in jds[i].items():
            np.testing.assert_allclose(ds[i][k], v, rtol=0, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("prefetch,num_workers", [(0, 1), (2, 1), (2, 3)])
def test_loader_matches_jax(prefetch, num_workers):
    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"x": np.full((2, 3), i, np.float32), "i": i}

    kw = dict(batch_size=4, shuffle=True, seed=3, prefetch=prefetch, num_workers=num_workers)
    got, want = list(DataLoader(Items(), **kw)), list(JDataLoader(Items(), **kw))
    assert len(got) == len(want) == 3 == len(DataLoader(Items(), **kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["i"], w["i"])
    assert len(list(DataLoader(Items(), drop_last=True, **kw))) == 2


def test_loader_reraises_in_the_consumer():
    class Bad:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise KeyError(i)

    with pytest.raises(KeyError):
        list(DataLoader(Bad(), batch_size=1))
