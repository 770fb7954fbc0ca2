"""How far train_r3_dp's two ranks drift from one rank, by the GAE its latents come from.

    python -m hsi_dmgasr_tpu_torch.tools.train_dp_divergence

Run from the root of a checkout on a machine with a CUDA GPU and nvcc.
It drives ``chip_smoke.run_train_r3_dp`` (three steps of train_r3 on 36
latents, one rank against two ranks sharing the card over gloo) three
times in one process: on the latents of a seeded, untrained GAE, then on
those of the GAE that ``chip_smoke.run_train_gae`` trains (as the whole
``chip_smoke.py`` run does), then on the seeded GAE again, after the
training ran in the same process. Each run's gates are chip_smoke's; a
run that misses them is reported, not raised. Prints each run's worst
readings (the share of first gradients whose sign differs, the share of
weights past 0.05 lr, Adam's moments) and writes
``chiprun_out/train_dp_divergence.json``.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.getcwd()


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    from ..device import use_f32_policy
    from ..kernels import build
    from ..train.stage1_gae import GAETrainer

    use_f32_policy()
    print(cs.card_line(), flush=True)
    build.build_all()
    dirs = cs.make_train_data(os.path.join(ROOT, "build", "scenes"))
    seeded = os.path.join(ROOT, "build", "gae_seeded")
    GAETrainer(**{k: cs.GAE_CFG[k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")},
               device="cuda").save(seeded)
    runs = {}

    def run(tag, ckpt):
        t0 = time.perf_counter()
        try:
            report = cs.run_train_r3_dp(dirs, ckpt)[0]
            runs[tag] = {"worst": report["worst_leaf_rel_err"],
                         "loss_rel_err": report["loss_rel_err"]}
        except AssertionError as e:
            runs[tag] = {"failed": str(e)}
        runs[tag]["seconds"] = time.perf_counter() - t0
        print(tag, json.dumps(runs[tag]), flush=True)

    run("seeded_gae", seeded)
    _, trained = cs.run_train_gae(dirs)
    run("trained_gae", trained)
    run("seeded_gae_after_training", seeded)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_dp_divergence.json"), "w") as f:
        json.dump({"card": cs.card_line(), "runs": runs}, f, indent=1)


if __name__ == "__main__":
    main()
