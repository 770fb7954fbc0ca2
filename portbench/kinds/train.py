"""Training traffic: stage-2 steps back to back, as the stage-2 driver runs
them with device-resident scenes (``train/stage2_driver.py``): each step
draws a batch of HR crops on the card (``DeviceSceneCache.sample``) and
runs ``DMGASRPipeline.train_step_from_hr`` (the degradation and both GAE
encodes on the card, one diffusion update on the folded latents: Adam,
the lr schedule, the EMA). The host does not wait for a step; the window
ends when the card has finished the last one.

The mix's parameters (``portbench/traffic/<name>.json``): ``scenes`` and
``scene_size``, the seeded structured scenes held on the card. The crop
size (``l_resolution`` x ``scale``) and the batch come from the
configuration's ``datasets.train``. Step k draws its crops from a
generator seeded by (seed, "crops", k) and its loss and dropout draws from
one seeded by (seed, "step", k).

Correctness: set-up builds the one training object and drives it through
steps 0, 1 and 2 with the window's own call and feed (they are also the
warm-up); the window goes on from step 3. After step 0 it keeps the first
gradients as Adam got them (its first moment / (1 - beta1)) and the EMA,
after step 2 the weights; the losses of the three. Once the window has
closed and the program is freed, the plain reference runs the same three
steps from the same weights, scenes and draws, and the check compares:
each step's loss (relative gap); per UNet weight, the norm of the first
gradient, the norm of the weights' change over the three steps and of the
EMA's, as the gap between the program's norm and the reference's over
the larger of the reference's norm of that weight and of the median
weight's; the worst weight counts. Weights whose reference gradient has a
norm under a thousandth of the median weight's move by round-off alone
and are left out of the changes.

``tiny`` and ``tiny_check`` give the mix and the check at the tests' tiny
size (``portbench/tests/tiny.py``).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import inputs, program, roofline
from portbench.reference import nets
from portbench.reference import train as ref_train

FIRST = 3  # steps driven in set-up and followed by the reference


def tiny(mix, size):
    """The mix at the tests' tiny size: two scenes of (2 size)^2."""
    return dict(mix, scenes=2, scene_size=2 * size)


def tiny_check(spec):
    """The cell's check at the tests' tiny size: the same three steps."""
    return spec


class Workload:
    def __init__(self, run):
        self.run, self.cfg, self.dev, self.seed = run, run.cfg, run.device, run.seed
        ds = self.cfg["datasets"]["train"]
        self.batch = ds["batch_size"]
        self.crop = ds["l_resolution"] * self.cfg["scale"]
        self.flops_per_call = roofline.train_step_flops(self.cfg, self.batch, self.crop)
        gae_state, unet_state = inputs.model_states(self.cfg, self.seed, self.dev)
        self.pipe = program.build(self.cfg, gae_state, unet_state, self.dev)
        del gae_state, unet_state
        run.mark("program")
        self.cache = program.scene_cache(self.scenes(), self.crop, self.dev)
        run.mark("inputs")
        unet = self.pipe.ddpm.unet
        self.losses = []
        for k in range(FIRST):
            self.losses.append(float(self._step(k)))
            if k == 0:
                opt = self.pipe.ddpm.optimizer
                b1 = opt.param_groups[0]["betas"][0]
                # an optimizer that kept no moment has passed on no gradient
                self.first_grads = {
                    n: (opt.state[p]["exp_avg"] / (1 - b1)).cpu() if opt.state.get(p)
                    else torch.zeros(p.shape) for n, p in unet.named_parameters()}
                self.ema = {n: p.detach().to("cpu", copy=True)
                            for n, p in self.pipe.ddpm.ema.module.named_parameters()}
        self.params = {n: p.detach().to("cpu", copy=True) for n, p in unet.named_parameters()}
        run.mark("first steps")

    def scenes(self):
        mix = self.run.mix
        return inputs.scenes(self.seed, "train", mix["scenes"], mix["scene_size"],
                             self.cfg["gae_widths"]["n_colors"], self.dev)

    def gens(self, k):
        return (inputs.generator(self.dev, self.seed, "crops", k),
                inputs.generator(self.dev, self.seed, "step", k))

    def _step(self, k):
        crops, step = self.gens(k)
        hr = self.cache.sample(crops, self.batch)
        return self.pipe.train_step_from_hr(hr, scale=self.cfg["scale"], generator=step)

    def call(self, k):
        """One timed step, the (FIRST + k)-th."""
        self._step(FIRST + k)

    def reference(self):
        """The plain reference's three steps, from the seed alone."""
        self.pipe = self.cache = None  # the program's state is freed first
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        gae_state, unet_state = inputs.model_states(self.cfg, self.seed, self.dev)
        with torch.device(self.dev):
            gae, unet = nets.gae_from_config(self.cfg), nets.UNet.from_config(self.cfg)
        gae.load_state_dict(gae_state)
        unet.load_state_dict(unet_state)
        initial = {n: p.detach().to("cpu", copy=True) for n, p in unet.named_parameters()}
        scenes = self.scenes()
        batches, gens = [], []
        for k in range(FIRST):
            crops, step = self.gens(k)
            batches.append(ref_train.crops(scenes, crops, self.batch, self.crop))
            gens.append(step)
        out = ref_train.steps(self.cfg, gae, unet, batches, gens)
        return initial, out

    def control(self):
        """The control of the check: the reference's own steps in TF32, in
        the program's place."""
        with nets.lower_precision():
            initial, out = self.reference()
        self.losses = out["losses"]
        self.first_grads = {n: g.cpu() for n, g in out["first_grads"].items()}
        self.params = {n: p.cpu() for n, p in out["params"].items()}
        self.ema = {n: p.cpu() for n, p in out["ema"].items()}

    def check(self):
        """The relative gap of the first step's loss; per UNet weight the gap
        of the norms (the program's and the reference's, over the larger of
        the reference's and the median weight's): of the first gradient,
        the worst weight; of the change over three steps and of the EMA's
        change over the first step, the median weight (the worst weight's
        EMA reads the f32 rounding of a 1e-7 change on its weights).
        The later steps' losses and the worst weight's change swing with
        Adam's early updates, lr * sign(g) at first, which move an element
        by 2 lr where rounding flips the sign of a gradient near 0; the
        first update's norm does not see a sign (PERF.md: the look at the
        train cell)."""
        initial, ref = self.reference()
        limits = self.run.check_spec["limits"]
        norm = lambda t: float(t.double().norm())  # noqa: E731
        g_ref = {n: norm(g) for n, g in ref["first_grads"].items()}
        g_med = float(np.median(list(g_ref.values())))
        moving = [n for n in g_ref if g_ref[n] >= 1e-3 * g_med]

        def gaps(mine, theirs, names):
            n_mine = {n: norm(mine[n]) for n in names}
            n_ref = {n: norm(theirs[n]) for n in names}
            med = float(np.median(list(n_ref.values())))
            return [abs(n_mine[n] - n_ref[n]) / max(n_ref[n], med) for n in names]

        change = lambda after: {n: after[n].cpu() - initial[n] for n in moving}  # noqa: E731
        vals = {
            "loss_gap": abs(self.losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": max(gaps(self.first_grads, {n: g.cpu() for n, g in
                                                    ref["first_grads"].items()}, list(g_ref))),
            "change_gap": float(np.median(gaps(change(self.params), change(ref["params"]),
                                               moving))),
            "ema_gap": float(np.median(gaps(change(self.ema), change(ref["ema"]), moving))),
        }
        return {k: {"value": v, "limit": limits[k]} for k, v in vals.items()}
