"""Cube traffic: one client super-resolves bicubic-upsampled LR cubes, one
call after the other (a closed loop), and waits for each.

The mix's parameters (``portbench/traffic/<name>.json``): ``size`` (the
cube's height and width), ``batch`` (cubes per call), ``pool`` (how many
seeded structured scenes the cubes cycle through). The bands and the
scale come from the configuration. Call k super-resolves cubes
k * batch ... of the pool, with its own draws: a generator seeded by
(seed, k), whose first draw starts the chain, and the noise of every step
(``inputs.chain_noise``). One call before the window warms up every shape.

Correctness (``portbench/workloads/<cell>.json``, ``check``): ``calls``
calls drawn from the seed among the window's first ``within`` keep their
output cube. Once the window has closed and the program is freed, the
plain reference super-resolves the same cubes from the same draws and the
same weights (made again from the seed), and each kept cube is compared
with it: the largest and the mean absolute gap over all its values.

``tiny`` and ``tiny_check`` give the mix and the check at the tests' tiny
size (``portbench/tests/tiny.py``).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import inputs, program, roofline
from portbench.reference import dmgasr, nets


def tiny(mix, size):
    """The mix at the tests' tiny size: ``size``^2 cubes, one a call, from
    a pool of two."""
    return dict(mix, size=size, batch=1, pool=2)


def tiny_check(spec):
    """The cell's check at the tests' tiny size: two calls among the first
    three."""
    return dict(spec, check={"calls": 2, "within": 3})


class Workload:
    def __init__(self, run):
        self.run, self.cfg, self.dev, self.seed = run, run.cfg, run.device, run.seed
        mix = run.mix
        self.batch, self.size, self.pool_n = mix["batch"], mix["size"], mix["pool"]
        self.bands = self.cfg["gae_widths"]["n_colors"]
        self.G = program.gae_config(self.cfg)["G"]
        self.steps = dmgasr.chain_start(self.cfg)
        self.flops_per_call = roofline.cube_flops(self.cfg, self.batch, self.size, self.steps)
        gae_state, unet_state = inputs.model_states(self.cfg, self.seed, self.dev)
        self.pipe = program.build(self.cfg, gae_state, unet_state, self.dev)
        del gae_state, unet_state
        run.mark("program")
        self.pool = inputs.sr_cubes(self.seed, self.pool_n, self.size, self.bands,
                                    self.cfg["scale"], self.dev)
        spec = run.check_spec["check"]
        rng = np.random.default_rng(inputs.derive(self.seed, "check"))
        self.keep = set(rng.choice(spec["within"], spec["calls"], replace=False).tolist())
        self.kept = {}
        run.mark("inputs")
        self._sync(self._call(-1))  # warm-up, on draws of its own
        run.mark("warm-up")

    def _sync(self, out):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return out

    def cubes(self, k):
        idx = [(k * self.batch + i) % self.pool_n for i in range(self.batch)]
        return self.pool[idx[0]:idx[0] + 1] if self.batch == 1 else self.pool[idx]

    def draws(self, k):
        """(the chain's generator, its noise) of call k."""
        shape = (self.batch * self.G, self.size, self.size, 3)
        return (inputs.generator(self.dev, self.seed, "start", k),
                inputs.chain_noise(self.seed, k, self.steps, shape, self.dev))

    def _call(self, k):
        g, noise = self.draws(k)
        return self.pipe.super_resolve(self.cubes(k), generator=g, noise_seq=noise)

    def call(self, k):
        """One timed call: the cube(s) of call k, waited for."""
        out = self._sync(self._call(k))
        if k in self.keep:
            self.kept[k] = out

    def reference(self, k):
        """The plain reference's cube(s) of call k, from the seed alone."""
        if getattr(self, "_ref", None) is None:
            self.pipe = None  # the program's state is freed first
            gc.collect()
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
            gae_state, unet_state = inputs.model_states(self.cfg, self.seed, self.dev)
            with torch.device(self.dev):
                gae, unet = nets.gae_from_config(self.cfg), nets.UNet.from_config(self.cfg)
            gae.load_state_dict(gae_state)
            unet.load_state_dict(unet_state)
            self._ref = gae, unet, nets.Precision.from_config(self.cfg)
        gae, unet, prec = self._ref
        g, noise = self.draws(k)
        eps = torch.randn(noise.shape[1:], generator=g, device=self.dev)
        return dmgasr.super_resolve(gae, unet, self.cubes(k), eps, noise, self.cfg, prec)

    def control(self):
        """The control of the check: the reference in TF32, in the program's
        place, for the same calls."""
        with nets.lower_precision():
            self.kept = {k: self.reference(k) for k in sorted(self.keep)}

    def check(self):
        """Each kept cube against the plain reference's: the largest and the
        mean absolute gap (inf where a cube is missing or not finite)."""
        limits = self.run.check_spec["limits"]
        worst = mean = float("inf") if not self.kept else 0.0
        for k in sorted(self.kept):
            gap = (self.kept[k].float() - self.reference(k)).abs()
            finite = bool(torch.isfinite(gap).all())
            worst = max(worst, float(gap.max()) if finite else float("inf"))
            mean = max(mean, float(gap.mean()) if finite else float("inf"))
        return {"cube_max_gap": {"value": worst, "limit": limits["cube_max_gap"]},
                "cube_mean_gap": {"value": mean, "limit": limits["cube_mean_gap"]}}
