"""Offline dataset builder (reference data/prepare_data.py): the port's
copy of ``hsi_dmgasr_tpu/data/prepare_data.py``.

Resizes source images to (low, high) pairs and a bicubic fake-SR, writing
either the folder layout the LRHR 'img' mode consumes:
  {out}_{l}_{r}/hr_{r}/*.png, lr_{l}/*.png, sr_{l}_{r}/*.png
or, with --lmdb, an LMDB database with the reference's key scheme
(prepare_data.py:83-92) through the dependency-free io/lmdb_lite writer.

A CPU tool; it needs PIL. ``--mode process`` (the default) runs the
reference's worker processes over a static file split with a shared
progress counter (prepare_data.py:50-134), started with the ``spawn``
method; ``--mode thread`` uses a thread pool (PNG encoding releases the
GIL). Run it as ``python -m hsi_dmgasr_tpu_torch.data.prepare_data
--path <images> --out <prefix> --size 16,128 [--lmdb]``.
"""

from __future__ import annotations

import argparse
import io
import multiprocessing as mp
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial


def resize_and_convert(img, size, resample):
    if img.size[0] != size:
        img = img.resize((size, size), resample)
    return img


def _triplet(path, sizes):
    """(hr, lr, sr) PIL images of one source image."""
    from PIL import Image

    low, high = sizes
    with Image.open(path) as src:
        img = src.convert("RGB")
    hr = resize_and_convert(img, high, Image.BICUBIC)
    lr = resize_and_convert(hr, low, Image.BICUBIC)
    sr = resize_and_convert(lr, high, Image.BICUBIC)
    return hr, lr, sr


def process_one(paths, out_dir, sizes):
    i, path = paths
    low, high = sizes
    hr, lr, sr = _triplet(path, sizes)
    stem = f"{i:05d}"
    hr.save(os.path.join(out_dir, f"hr_{high}", f"{stem}.png"))
    lr.save(os.path.join(out_dir, f"lr_{low}", f"{stem}.png"))
    sr.save(os.path.join(out_dir, f"sr_{low}_{high}", f"{stem}.png"))


def _source_files(path):
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".webp")
    return sorted(os.path.join(dp, f) for dp, _, fns in os.walk(path)
                  for f in fns if f.lower().endswith(exts))


def _mp_worker(items, out_dir, sizes, counter):
    """Process worker (reference prepare_data.py:50-68): convert an item
    slice, bumping the shared progress counter per item."""
    for item in items:
        process_one(item, out_dir=out_dir, sizes=sizes)
        with counter.get_lock():
            counter.value += 1


def prepare(path, out, size="16,128", n_worker=8, mode="process", progress=False):
    """The folder layout under ``{out}_{low}_{high}``; returns (that
    directory, the number of source images)."""
    sizes = tuple(int(s) for s in size.split(","))
    low, high = sizes
    out_dir = f"{out}_{low}_{high}"
    for sub in (f"hr_{high}", f"lr_{low}", f"sr_{low}_{high}"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    files = _source_files(path)
    if mode == "thread" or n_worker <= 1 or not files:
        worker = partial(process_one, out_dir=out_dir, sizes=sizes)
        with ThreadPoolExecutor(max_workers=max(n_worker, 1)) as ex:
            list(ex.map(worker, enumerate(files)))
        return out_dir, len(files)

    # one OS process per worker over a static file split, with a shared
    # counter driving the progress readout (prepare_data.py:95-134)
    ctx = mp.get_context("spawn")
    n_worker = min(n_worker, len(files))
    counter = ctx.Value("i", 0)
    items = list(enumerate(files))
    procs = [ctx.Process(target=_mp_worker, args=(items[w::n_worker], out_dir, sizes, counter))
             for w in range(n_worker)]
    for p in procs:
        p.start()
    while any(p.is_alive() for p in procs):
        if progress:
            print(f"\r{counter.value}/{len(files)}", end="", file=sys.stderr, flush=True)
        time.sleep(0.1)
    for p in procs:
        p.join()
        if p.exitcode:
            raise RuntimeError(f"prepare_data worker exited {p.exitcode}")
    if progress:
        print(f"\r{counter.value}/{len(files)}", file=sys.stderr)
    if counter.value != len(files):
        raise RuntimeError(f"prepare_data converted {counter.value} of {len(files)} images")
    return out_dir, len(files)


def prepare_lmdb(path, out, size="16,128"):
    """An SR3 lmdb database under ``{out}_{low}_{high}`` (reference
    prepare_data.py:83-92 key scheme: hr_{r}_{i:05d}, lr_{l}_{i:05d},
    sr_{l}_{r}_{i:05d}, length)."""
    from ..io.lmdb_lite import LmdbWriter

    sizes = tuple(int(s) for s in size.split(","))
    low, high = sizes
    out_dir = f"{out}_{low}_{high}"
    files = _source_files(path)

    def png_bytes(img):
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        return buf.getvalue()

    with LmdbWriter(out_dir) as w:
        for i, p in enumerate(files):
            hr, lr, sr = _triplet(p, sizes)
            w.put(f"hr_{high}_{i:05d}", png_bytes(hr))
            w.put(f"lr_{low}_{i:05d}", png_bytes(lr))
            w.put(f"sr_{low}_{high}_{i:05d}", png_bytes(sr))
        w.put("length", str(len(files)))
    return out_dir, len(files)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--size", default="16,128")
    p.add_argument("--n_worker", type=int, default=8)
    p.add_argument("--mode", choices=["process", "thread"], default="process",
                   help="process = reference-style worker processes with a shared "
                        "progress counter")
    p.add_argument("-l", "--lmdb", action="store_true")
    args = p.parse_args(argv)
    if args.lmdb:
        out_dir, n = prepare_lmdb(args.path, args.out, args.size)
    else:
        out_dir, n = prepare(args.path, args.out, args.size, args.n_worker,
                             mode=args.mode, progress=True)
    print(f"wrote {n} triplets to {out_dir}")
    return out_dir, n


if __name__ == "__main__":
    main()
