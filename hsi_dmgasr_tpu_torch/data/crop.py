"""Scene cropping (reference GAE/crop.py:41-72): a copy of
``hsi_dmgasr_tpu/data/crop.py``.

Cuts a large HSI scene into its four corner and its centre blocks and
saves them as ``.npy``: the reference's offline preparation of 512^2
test blocks, which ``pipeline.py:super_resolve_tiled`` replaces online.

    python -m hsi_dmgasr_tpu_torch.data.crop --input scene.mat --key block --size 512 --out crops
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def corner_center_crops(img, size):
    """Four corner crops and the centre crop of an (H, W, C) scene."""
    h, w, _ = img.shape
    if h < size or w < size:
        raise ValueError(f"scene {img.shape} smaller than crop {size}")
    y_c = (h - size) // 2
    x_c = (w - size) // 2
    return {
        "tl": img[:size, :size],
        "tr": img[:size, w - size:],
        "bl": img[h - size:, :size],
        "br": img[h - size:, w - size:],
        "center": img[y_c:y_c + size, x_c:x_c + size],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="corner and centre crops of an HSI scene")
    p.add_argument("--input", required=True, help=".mat (key) or .npy scene")
    p.add_argument("--key", default="block")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    if args.input.endswith(".npy"):
        img = np.load(args.input)
    else:
        import scipy.io as sio

        img = np.asarray(
            sio.loadmat(args.input, verify_compressed_data_integrity=False)[args.key])
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.splitext(os.path.basename(args.input))[0]
    for name, crop in corner_center_crops(img, args.size).items():
        np.save(os.path.join(args.out, f"{stem}_{name}.npy"), crop.astype(np.float32))
    print(f"wrote 5 crops of {args.size}^2 to {args.out}")


if __name__ == "__main__":
    main()
