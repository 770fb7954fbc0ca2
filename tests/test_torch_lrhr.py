"""The LRHR/LMDB data path of the port against the JAX package: the LMDB
reader and writer, LRHRDataset in its 'img', 'lmdb' and 'list' modes,
the dataset builder with its CLI, the factory and paired_random_augment.

Everything here is host-side numpy and bytes, so every comparison is
exact: the same keys and bytes, the same files, items equal bit for bit
on the same files and the same numpy rng. PNG decoding needs PIL.
"""

import io
import json
import os
import zlib

import numpy as np
import pytest

from hsi_dmgasr_tpu.data import factory as j_factory
from hsi_dmgasr_tpu.data.lrhr import LRHRDataset as JLRHRDataset
from hsi_dmgasr_tpu.data.prepare_data import prepare as j_prepare
from hsi_dmgasr_tpu.io.lmdb_lite import LmdbReader as JReader
from hsi_dmgasr_tpu.io.lmdb_lite import LmdbWriter as JWriter
from hsi_dmgasr_tpu.utils.augment import paired_random_augment as j_augment
from hsi_dmgasr_tpu_torch.data import factory
from hsi_dmgasr_tpu_torch.data.lrhr import LRHRDataset
from hsi_dmgasr_tpu_torch.data.prepare_data import main as prepare_main
from hsi_dmgasr_tpu_torch.data.prepare_data import prepare
from hsi_dmgasr_tpu_torch.io.lmdb_lite import LmdbReader, LmdbWriter
from hsi_dmgasr_tpu_torch.utils.augment import paired_random_augment

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "canonical_small.mdb")


def test_reader_reads_the_canonical_fixture_as_the_jax_reader():
    with open(GOLDEN + ".json") as f:
        manifest = json.load(f)
    with LmdbReader(GOLDEN) as r, JReader(GOLDEN) as jr:
        assert r.psize == jr.psize == 4096
        assert len(r) == len(jr) == len(manifest)
        items, jitems = list(r.items()), list(jr.items())
        assert items == jitems
        assert [k.decode() for k, _ in items] == sorted(manifest)
        for k, meta in manifest.items():
            v = r.get(k)
            assert v == jr.get(k) and zlib.crc32(v) == meta["crc32"], k
        assert len(r.get("big_blob")) == 8500
        assert r.get("nope") is None and r.get(b"hr_128_00000") is None


def test_writer_round_trip_and_same_file_as_jax(tmp_path):
    """Enough entries for several leaf pages and a branch level, and values
    past the page size (overflow pages): the port's file is the JAX
    writer's byte for byte, and each reader reads the other's."""
    rng = np.random.RandomState(0)
    kv = {f"key_{i:05d}".encode(): rng.bytes(rng.randint(1, 50)) for i in range(600)}
    kv.update({f"big_{i:02d}".encode(): rng.bytes(5000 + 1000 * i) for i in range(4)})
    mine, theirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    for cls, path in ((LmdbWriter, mine), (JWriter, theirs)):
        with cls(path) as w:
            for k, v in kv.items():
                w.put(k, v)
    with open(os.path.join(mine, "data.mdb"), "rb") as a, \
            open(os.path.join(theirs, "data.mdb"), "rb") as b:
        assert a.read() == b.read()
    with LmdbReader(theirs) as r, JReader(mine) as jr:
        assert dict(r.items()) == dict(jr.items()) == kv
        assert r.get("alpha") is None


def _png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """Five seeded RGB source images of 40^2."""
    pytest.importorskip("PIL")
    from PIL import Image

    src = tmp_path_factory.mktemp("src")
    rng = np.random.RandomState(2)
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)).save(str(src / f"{i}.png"))
    return str(src)


def _tree(d):
    out = {}
    for dp, _, fns in os.walk(d):
        for f in fns:
            with open(os.path.join(dp, f), "rb") as fh:
                out[os.path.relpath(os.path.join(dp, f), d)] = fh.read()
    return out


@pytest.mark.parametrize("mode,n_worker", [("thread", 2), ("process", 2)])
def test_prepare_folders_match_jax(tmp_path, sources, mode, n_worker):
    out_dir, n = prepare(sources, str(tmp_path / "mine"), size="16,32", n_worker=n_worker,
                         mode=mode)
    j_out, jn = j_prepare(sources, str(tmp_path / "theirs"), size="16,32", n_worker=1,
                          mode="thread")
    assert n == jn == 5 and out_dir.endswith("mine_16_32")
    mine, theirs = _tree(out_dir), _tree(j_out)
    assert sorted(mine) == sorted(theirs) and len(mine) == 15
    assert mine == theirs


def _pair(sources, tmp_path, lmdb):
    """The same prepared dataset from the port's CLI, once per package's
    reading."""
    argv = ["--path", sources, "--out", str(tmp_path / "ds"), "--size", "16,32",
            "--mode", "thread", "--n_worker", "1"] + (["--lmdb"] if lmdb else [])
    out_dir, n = prepare_main(argv)
    assert n == 5
    return out_dir


@pytest.mark.parametrize("datatype", ["img", "lmdb"])
@pytest.mark.parametrize("need_LR,split", [(True, "train"), (False, "val")])
def test_lrhr_items_equal_jax(tmp_path, sources, datatype, need_LR, split):
    root = _pair(sources, tmp_path, datatype == "lmdb")
    kw = dict(datatype=datatype, l_resolution=16, r_resolution=32, split=split,
              need_LR=need_LR)
    ds = LRHRDataset(root, rng=np.random.RandomState(4), **kw)
    jds = JLRHRDataset(root, rng=np.random.RandomState(4), **kw)
    assert len(ds) == len(jds) == 5
    for i in (0, 3, 1, 4, 2, 3):
        a, b = ds[i], jds[i]
        assert a.keys() == b.keys() == ({"LR", "SR", "HR", "Index"} if need_LR
                                        else {"SR", "HR", "Index"})
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{datatype} {i} {k}")
    assert ds[0]["HR"].shape == (32, 32, 3) and ds[0]["HR"].dtype == np.float32


def test_lrhr_list_mode_equals_jax(tmp_path):
    """'list' mode: "lr hr" pairs, the SR by the torch-style bicubic, random
    128^2 crops from the dataset's rng."""
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.RandomState(6)
    lines = []
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (34, 34, 3), np.uint8)).save(
            str(tmp_path / f"lr{i}.png"))
        Image.fromarray(rng.randint(0, 255, (136, 136, 3), np.uint8)).save(
            str(tmp_path / f"hr{i}.png"))
        lines.append(f"lr{i}.png hr{i}.png")
    (tmp_path / "pairs.txt").write_text("\n".join(lines) + "\n")
    kw = dict(datatype="list", list_file="pairs.txt", split="train", need_LR=True)
    ds = LRHRDataset(str(tmp_path), rng=np.random.RandomState(1), **kw)
    jds = JLRHRDataset(str(tmp_path), rng=np.random.RandomState(1), **kw)
    for i in (0, 1, 0):
        a, b = ds[i], jds[i]
        assert a["HR"].shape == (128, 128, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")


def test_factory_batches_equal_jax(tmp_path, sources):
    root = _pair(sources, tmp_path, lmdb=True)
    opt = {"mode": "LRHR", "dataroot": root, "datatype": "lmdb", "l_resolution": 16,
           "r_resolution": 32, "data_len": 4, "batch_size": 2, "use_shuffle": True}
    for phase in ("train", "val"):
        ds = factory.create_dataset(opt, phase)
        jds = j_factory.create_dataset(opt, phase)
        ds.rng, jds.rng = np.random.RandomState(3), np.random.RandomState(3)
        assert len(ds) == 4
        batches = list(factory.create_dataloader(ds, opt, phase))
        jbatches = list(j_factory.create_dataloader(jds, opt, phase))
        assert len(batches) == len(jbatches) == (2 if phase == "train" else 4)
        for a, b in zip(batches, jbatches):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{phase} {k}")
    with pytest.raises(NotImplementedError):
        factory.create_dataloader(ds, opt, "test")


@pytest.mark.parametrize("seed", range(6))
def test_paired_random_augment_equals_jax(seed):
    rng = np.random.RandomState(seed)
    imgs = [rng.rand(6, 6, 3).astype(np.float32), rng.rand(12, 12, 3).astype(np.float32)]
    for make in (np.random.RandomState, np.random.default_rng):
        a = paired_random_augment(imgs, make(seed))
        b = j_augment(imgs, make(seed))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
            assert x.flags["C_CONTIGUOUS"]
    for x, y in zip(paired_random_augment(imgs, np.random.RandomState(seed), train=False),
                    imgs):
        np.testing.assert_array_equal(x, y)
