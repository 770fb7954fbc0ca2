"""A kind of the probe's own (``test_portbench_probe.py`` writes it into a
copy as ``portbench/kinds/probe_forward.py``): one forward of the port's
SR3 UNet (``models/unet.py``) a call, at the mix's ``batch`` and ``size``,
on weights and inputs drawn from the seed. The first two calls keep their
output (a short window may make only one); the check compares each with
``reference/nets.py``'s UNet on the same weights and inputs: the largest
absolute gap, infinite where nothing was kept."""

from __future__ import annotations

import gc

import torch

from portbench import inputs, roofline
from portbench.reference import nets


def tiny(mix, size):
    return dict(mix, size=size, batch=1)


def tiny_check(spec):
    return spec


class Workload:
    def __init__(self, run):
        from hsi_dmgasr_tpu_torch.device import use_f32_policy
        from hsi_dmgasr_tpu_torch.io.convert_torch import load_state_dict
        from hsi_dmgasr_tpu_torch.models.networks import define_G

        self.run, self.cfg, self.dev, self.seed = run, run.cfg, run.device, run.seed
        self.batch, self.size = run.mix["batch"], run.mix["size"]
        widths, gae = roofline.model_widths(self.cfg)
        assert gae is None
        self.flops_per_call = roofline.unet_flops(self.batch, self.size, **widths)
        gae_state, unet_state = inputs.model_states(self.cfg, self.seed, self.dev)
        assert gae_state is None
        use_f32_policy()
        self.unet, _ = define_G({"model": self.cfg["model"]})
        load_state_dict(self.unet, unet_state)
        self.unet.to(self.dev).eval()
        self.keep, self.kept = {0, 1}, {}
        self._call(-1)  # warm-up, on inputs of its own

    def inputs(self, k):
        g = inputs.generator(self.dev, self.seed, "probe", k)
        c = self.cfg["model"]["unet"]["in_channel"]
        x = torch.randn((self.batch, self.size, self.size, c), generator=g, device=self.dev)
        return x, torch.rand((self.batch, 1), generator=g, device=self.dev)

    def _call(self, k):
        with torch.no_grad():
            return self.unet(*self.inputs(k))

    def call(self, k):
        out = self._call(k)
        if k in self.keep:
            self.kept[k] = out

    def reference(self, k):
        if getattr(self, "_ref", None) is None:
            self.unet = None  # the program's state is freed first
            gc.collect()
            _, state = inputs.model_states(self.cfg, self.seed, self.dev)
            with torch.device(self.dev):
                ref = nets.UNet.from_config(self.cfg)
            ref.load_state_dict(state)
            self._ref = ref, nets.Precision.from_config(self.cfg)
        ref, prec = self._ref
        x, gamma = self.inputs(k)
        with torch.no_grad():
            return ref(x.permute(0, 3, 1, 2), gamma, prec).permute(0, 2, 3, 1)

    def control(self):
        with nets.lower_precision():
            self.kept = {k: self.reference(k) for k in sorted(self.keep)}

    def check(self):
        worst = float("inf") if not self.kept else 0.0
        for k in sorted(self.kept):
            worst = max(worst, float((self.kept[k] - self.reference(k)).abs().max()))
        return {"forward_max_gap": {"value": worst,
                                    "limit": self.run.check_spec["limits"]["forward_max_gap"]}}
