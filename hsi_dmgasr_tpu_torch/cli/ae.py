"""Stage-1 GAE training entry point (reference AE.py:516-637 ``__main__``), on the card.

    python -m hsi_dmgasr_tpu_torch.cli.ae --data /path/to/scenes --datatype hsi_mat \\
        --device_resident --epochs 5 --out ./weight/gae_pav

Port of ``hsi_dmgasr_tpu/cli/ae.py`` with the same flags, except
``--device`` (default CUDA, raises without it; ``cpu`` runs on the CPU)
in place of ``--platform``. ``--out`` is a directory that
``GAETrainer.save`` rewrites after every epoch; stage 2 takes it as its
``gae.checkpoint``.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from ..data.device_cache import DeviceSceneCache
from ..data.hs_datasets import HSTrainingData
from ..data.loader import DataLoader
from ..data.mat_folder import TrainsetFromFolder
from ..device import resolve_device, use_f32_policy
from ..train.stage1_gae import GAETrainer
from ..train.stage2_driver import derive_seed

logger = logging.getLogger("base")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", required=True, help=".mat pair dir or scene dir")
    p.add_argument("--datatype", choices=["mat_pairs", "hsi_mat"], default="mat_pairs")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n_subs", type=int, default=16)
    p.add_argument("--n_ovls", type=int, default=4)
    p.add_argument("--n_colors", type=int, default=102)
    p.add_argument("--n_feats", type=int, default=64)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--out", default="./weight/gae")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu to run on the CPU)")
    p.add_argument("--max_steps", type=int, default=None)
    # the AEddp masked-reconstruction recipe (GAE/AEddp.py:196-247):
    # --mask_p 0.6 --loss l1 reproduces the distributed stage-1 trainer
    p.add_argument("--mask_p", type=float, default=0.0)
    p.add_argument("--loss", choices=["hloss", "l1"], default="hloss")
    p.add_argument("--transfer_dtype", choices=["float16", "float32"], default="float16",
                   help="host->device dtype of the HR batches (float16 halves the copy and "
                        "rounds the cube before the step; float32 keeps full precision)")
    p.add_argument("--device_resident", action="store_true",
                   help="hsi_mat only: keep the normalised scenes in device memory and "
                        "sample crop+augment batches there (data/device_cache.py): no "
                        "per-step host transfer")
    args = p.parse_args(argv)
    if args.device_resident and args.datatype != "hsi_mat":
        p.error("--device_resident requires --datatype hsi_mat")
    return args


def main(argv=None):
    """Train, saving to ``--out`` after every epoch; returns the trainer."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    use_f32_policy()
    logging.basicConfig(level=logging.INFO)
    if args.datatype == "mat_pairs":
        ds = TrainsetFromFolder(args.data, scale=args.scale)
    else:
        ds = HSTrainingData(args.data, n_scale=args.scale, augment=True, hr_only=True)

    trainer = GAETrainer(n_subs=args.n_subs, n_ovls=args.n_ovls, n_colors=args.n_colors,
                         n_feats=args.n_feats, lr=args.lr, seed=args.seed,
                         mask_p=args.mask_p, loss=args.loss, device=device)

    if args.device_resident:
        cache = DeviceSceneCache.from_dataset(ds, gt_size=32 * args.scale, device=device)
        steps_per_epoch = max(1, len(ds) // args.batch_size)
        logger.info("device-resident: %d scenes on %s", cache.n_scenes, device)

        def batches(start):
            """Each batch from a generator seeded by its absolute step."""
            for j in range(steps_per_epoch):
                gen = torch.Generator(device=device).manual_seed(
                    derive_seed(args.seed ^ 0x5CE9E5, start + 1 + j))
                yield cache.sample(gen, args.batch_size)
    else:
        loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True, seed=args.seed)
        transfer_dtype = np.dtype(args.transfer_dtype)

        def batches(start):
            for batch in loader:
                hr = batch["HR"] if isinstance(batch, dict) else batch[1]
                yield np.asarray(hr, transfer_dtype)

    step = 0
    for epoch in range(args.epochs):
        for hr in batches(step):
            loss = trainer.train_step(hr)
            step += 1
            if step % 10 == 0:
                logger.info("epoch %d step %d loss %.5f", epoch, step, float(loss))
            if args.max_steps and step >= args.max_steps:
                break
        trainer.save(args.out)
        logger.info("saved %s after epoch %d", args.out, epoch)
        if args.max_steps and step >= args.max_steps:
            break
    return trainer


if __name__ == "__main__":
    main()
