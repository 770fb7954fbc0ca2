"""DMGASR stage-2 entry point (reference sr_gae.py), on the card.

    python -m hsi_dmgasr_tpu_torch.cli.sr_gae -c configs/pavia_x4_r3.json -p train

``--device`` defaults to CUDA and the run raises without it; ``--device
cpu`` runs on the CPU. ``path.resume_state`` in the config resumes a run.
The JAX CLI's ``--supervise`` (a relauncher for a dropped remote TPU
backend), ``--resume`` and ``--platform`` are not ported.
"""

from __future__ import annotations

import argparse

from .. import config as config_mod
from ..device import resolve_device
from ..train import stage2_driver


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-c", "--config", type=str, default="configs/pavia_x4.json")
    p.add_argument("-p", "--phase", type=str, choices=["train", "val"], default="train")
    p.add_argument("-debug", "-d", action="store_true",
                   help="miniature run: val every 2 steps, T=10, a few items")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--experiments_root", type=str, default=None,
                   help="pin the experiment dir (default: experiments/{name}_{timestamp})")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu to run on the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)  # raises before any directory is made
    opt = config_mod.parse(args.config, phase=args.phase,
                           experiments_root=args.experiments_root, debug=args.debug)
    if args.phase == "train":
        return stage2_driver.train(opt, seed=args.seed, device=device)
    return stage2_driver.run_val_phase(opt, seed=args.seed, device=device)


if __name__ == "__main__":
    main()
