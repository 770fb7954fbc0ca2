"""GAE reconstruction round trip (reference GAE/AE_test.py), on the card.

    python -m hsi_dmgasr_tpu_torch.cli.gae_test --ckpt GAE_4_Pav.pth \\
        --data /path/npy_scenes --gt_size 64

Port of ``hsi_dmgasr_tpu/cli/gae_test.py``. Loads a GAE checkpoint (a
whole-module ``.pth``, or a directory written by ``GAETrainer.save``),
encodes and decodes each ``HSTestData`` cube, clips to [0, 1], and prints
the HSI quality suite per cube and averaged. ``--device`` (default CUDA,
raises without it; ``cpu`` runs on the CPU) replaces ``--platform``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data.hs_datasets import HSTestData
from ..device import resolve_device, use_f32_policy
from ..evalhsi.metrics import quality_assessment, sum_dict
from ..io.convert_torch import load_state_dict, load_torch_gae
from ..models.gae import GAE
from ..train.stage1_gae import GAETrainer


def load_gae(ckpt):
    """(state_dict, config) of a ``.pth`` whole-module GAE or a stage-1
    checkpoint directory."""
    if ckpt.endswith(".pth"):
        return load_torch_gae(ckpt)
    return GAETrainer.load_gae_variables(ckpt)


def main(argv=None):
    """Returns the averaged metrics."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--gt_size", type=int, default=64)
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu to run on the CPU)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    use_f32_policy()

    sd, cfg = load_gae(args.ckpt)
    gae = GAE(n_subs=cfg["n_subs"], n_ovls=cfg["n_ovls"], n_colors=cfg["n_colors"],
              n_feats=cfg["n_feats"])
    load_state_dict(gae, sd)
    gae.to(device).eval()

    ds = HSTestData(args.data, n_scale=args.scale, gt_size=args.gt_size)
    indices = None
    for i in range(len(ds)):
        gt = ds[i]["HR"]
        with torch.inference_mode():
            recon, _ = gae(torch.as_tensor(gt[None], device=device))
        recon = np.clip(recon[0].cpu().numpy(), 0, 1)
        qa = quality_assessment(gt, recon, data_range=1.0, ratio=args.scale)
        print(f"cube {i}: {qa}")
        indices = qa if indices is None else sum_dict(indices, qa)
    indices = {k: v / len(ds) for k, v in indices.items()}
    print(f"averaged reconstruction metrics: {indices}")
    return indices


if __name__ == "__main__":
    main()
