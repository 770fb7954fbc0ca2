"""Training entry of the 3-D attention GAN (reference GAE/train.py +
GAE/icvl_train.py): RaGAN over ICVL-style tiled scenes, on the card:

    python -m hsi_dmgasr_tpu_torch.cli.gan_train --data scenes.npy --n_bands 31 \\
        --epochs 5 --out ./weight/gan3d

Port of ``hsi_dmgasr_tpu/cli/gan_train.py`` with the same arguments,
except ``--device`` (default CUDA, raises without it; ``cpu`` runs on the
CPU) in place of ``--platform``; ``--out`` is the port's checkpoint
directory (``GAN3DTrainer.save``) in place of the JAX package's orbax one.
"""

from __future__ import annotations

import argparse
import logging

from ..data.loader import DataLoader
from ..data.scenes import ICVLTiles
from ..device import resolve_device, use_f32_policy
from ..train.gan_trainer import GAN3DTrainer

logger = logging.getLogger("base")


def main(argv=None):
    """Train, then save to ``--out``; returns the trainer."""
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True, help="stacked-scene .npy")
    p.add_argument("--n_bands", type=int, default=31)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--fis", type=int, default=144)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu to run on the CPU)")
    p.add_argument("--out", default="./weight/gan3d")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    use_f32_policy()
    logging.basicConfig(level=logging.INFO)
    ds = ICVLTiles(args.data, s=args.scale, fis=args.fis)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True, seed=args.seed)
    trainer = GAN3DTrainer(n_bands=args.n_bands, lr_g=args.lr, lr_d=args.lr, seed=args.seed,
                           device=device)
    step = 0
    for epoch in range(args.epochs):
        for lr_cube, hr in loader:
            g_loss, d_loss = trainer.train_step(lr_cube, hr)
            step += 1
            if step % 5 == 0:
                logger.info("epoch %d step %d g=%.4f d=%.4f", epoch, step, float(g_loss),
                            float(d_loss))
            if args.max_steps and step >= args.max_steps:
                break
        if args.max_steps and step >= args.max_steps:
            break
    trainer.save(args.out)
    logger.info("saved %s", args.out)
    return trainer


if __name__ == "__main__":
    main()
