"""Train and test entry of the baseline zoo (reference GAE/*_train.py,
GAE/test.py), on the card:

    python -m hsi_dmgasr_tpu_torch.cli.baselines train --model sspsr \\
        --data /path/mat_scenes --n_colors 102 --scale 4 --out ./weight/sspsr
    python -m hsi_dmgasr_tpu_torch.cli.baselines test --model sspsr \\
        --data /path/npy_scenes --ckpt ./weight/sspsr --n_colors 102

Port of ``hsi_dmgasr_tpu/cli/baselines.py`` with the same arguments,
except ``--device`` (default CUDA, raises without it; ``cpu`` runs on the
CPU) in place of ``--platform``. ``--out`` is a directory that
``BaselineTrainer.save`` rewrites after every epoch. Two repairs of the
JAX CLI (ROADMAP.md §3): ``--model gdrrn`` takes the bicubic-upsampled
cube (``SR``), the input the model is built for, not the LR cube; and
``--model edsr`` with ``--scale`` other than 2 raises ``ValueError``, as
the reference pins EDSR at x2.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from ..data.hs_datasets import HSTestData, HSTrainingData
from ..data.loader import DataLoader
from ..device import resolve_device, use_f32_policy
from ..evalhsi.metrics import quality_assessment, sum_dict
from ..train.baseline_trainer import BaselineTrainer

logger = logging.getLogger("base")


def add_common(p):
    p.add_argument("--model", required=True, choices=["sspsr", "gelin", "edsr", "mcnet", "gdrrn"])
    p.add_argument("--data", required=True)
    p.add_argument("--n_colors", type=int, default=31)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--n_feats", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu to run on the CPU)")


def inputs(model, item):
    """(the model's input, its lms or None) of a batch or an item: GDRRN
    refines the bicubic-upsampled cube; GELIN adds its lms (SSPSR takes
    the LR cube as its lms, as in the JAX CLI)."""
    if model == "gdrrn":
        return item["SR"], None
    return item["LR"], item["SR"] if model == "gelin" else None


def main(argv=None):
    """Train (returns the trainer) or test (prints and returns the metrics
    averaged over the scenes)."""
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    tr = sub.add_parser("train")
    add_common(tr)
    tr.add_argument("--epochs", type=int, default=40)
    tr.add_argument("--batch_size", type=int, default=16)
    tr.add_argument("--lr", type=float, default=1e-4)
    tr.add_argument("--out", default="./weight/baseline")
    tr.add_argument("--max_steps", type=int, default=None)
    tr.add_argument("--grad_clip", type=float, default=None)
    te = sub.add_parser("test")
    add_common(te)
    te.add_argument("--ckpt", required=True)
    te.add_argument("--gt_size", type=int, default=64)
    args = ap.parse_args(argv)
    if args.model == "edsr" and args.scale != 2:
        raise ValueError(f"--model edsr upsamples x2 only (the reference pins scale=2, "
                         f"GAE/EDSR.py); got --scale {args.scale}")

    device = resolve_device(args.device)
    use_f32_policy()
    logging.basicConfig(level=logging.INFO)
    overrides = {"n_feats": args.n_feats} if args.n_feats else {}

    if args.cmd == "train":
        trainer = BaselineTrainer(args.model, args.n_colors, args.scale, lr=args.lr,
                                  seed=args.seed, grad_clip=args.grad_clip, device=device,
                                  **overrides)
        ds = HSTrainingData(args.data, n_scale=args.scale, augment=True)
        loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True, seed=args.seed)
        step = 0
        for epoch in range(args.epochs):
            for batch in loader:
                x, lms = inputs(args.model, batch)
                loss = trainer.train_step(x, batch["HR"], lms=lms)
                step += 1
                if step % 10 == 0:
                    logger.info("epoch %d step %d loss %.5f", epoch, step, float(loss))
                if args.max_steps and step >= args.max_steps:
                    break
            trainer.save(args.out)
            if args.max_steps and step >= args.max_steps:
                break
        logger.info("saved %s", args.out)
        return trainer

    trainer = BaselineTrainer(args.model, args.n_colors, args.scale, seed=args.seed,
                              device=device, **overrides)
    trainer.load(args.ckpt)
    ds = HSTestData(args.data, n_scale=args.scale, gt_size=args.gt_size)
    indices, n = None, 0
    for i in range(len(ds)):
        item = ds[i]
        x, lms = inputs(args.model, item)
        pred = trainer.predict(x[None], None if lms is None else lms[None])[0]
        pred = np.clip(pred.float().cpu().numpy(), 0, 1)
        qa = quality_assessment(item["HR"], pred, data_range=1.0, ratio=args.scale)
        indices = qa if indices is None else sum_dict(indices, qa)
        n += 1
    indices = {k: v / n for k, v in indices.items()}
    print(indices)
    return indices


if __name__ == "__main__":
    main()
