"""Train state in PyTorch's idiom: Adam, the lr schedules, EMA.

Port of ``hsi_dmgasr_tpu/train/state.py`` and the optimizer half of
``hsi_dmgasr_tpu/train/ddpm_model.py:69-115``:

  * ``torch.optim.Adam`` with optax's defaults (betas 0.9/0.999, eps 1e-8
    added to sqrt(v_hat), no weight decay), at ``train.optimizer.lr``;
  * ``train.optimizer.lr_schedule`` as a ``LambdaLR`` whose k-th update
    (k from 0) uses schedule(k), as optax counts: ``{"type": "step",
    "milestones": [...], "gamma": g}`` (piecewise constant, scaled by g
    once k >= each milestone) or ``{"type": "cosine", "decay_steps": D,
    "alpha": a}`` (lr * ((1 - a) * (1 + cos(pi * min(k, D) / D)) / 2 + a));
  * ``model.finetune_norm``: the reference's no-op (model/model.py:26-35
    hands only 'transformer' params to the optimizer; the UNet has none,
    so nothing trains);
  * ``EMA``: a copy of the module that starts at its initial weights and
    is updated after every step, from step 0, with ``ema_decay`` in f32.
    ``step_start_ema`` and ``update_ema_every`` are read by nothing, as in
    the JAX package.
"""

from __future__ import annotations

import copy
import logging
import math

import torch


def lr_factor(sched_cfg):
    """The schedule's factor on the base lr at update k (from 0)."""
    if not sched_cfg:
        return lambda k: 1.0
    typ = sched_cfg.get("type", "step")
    if typ == "step":
        gamma = sched_cfg.get("gamma", 0.1)
        # a dict, as optax's boundaries_and_scales: repeated milestones count once
        milestones = sorted({int(m) for m in sched_cfg["milestones"]})
        return lambda k: gamma ** sum(k >= m for m in milestones)
    if typ == "cosine":
        decay_steps = sched_cfg["decay_steps"]
        alpha = sched_cfg.get("alpha", 0.0)

        def cosine(k):
            c = 0.5 * (1.0 + math.cos(math.pi * min(k, decay_steps) / decay_steps))
            return (1.0 - alpha) * c + alpha

        return cosine
    raise NotImplementedError(f"lr_schedule type [{typ}]")


def build_optimizer(module, opt):
    """(Adam, LambdaLR) over ``module``'s parameters from the config."""
    opt_cfg = (opt.get("train") or {}).get("optimizer") or {}
    params = list(module.parameters())
    if (opt.get("model") or {}).get("finetune_norm"):
        params = [p for n, p in module.named_parameters() if "transformer" in n]
        logging.getLogger("hsi_dmgasr_tpu_torch").warning(
            "finetune_norm=True masks updates to 'transformer' params; "
            "this UNet has none, so NO parameters will train "
            "(reference-parity no-op, model/model.py:26-35)")
    optimizer = torch.optim.Adam([{"params": params}], lr=opt_cfg.get("lr", 1e-4),
                                 betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                  lr_factor(opt_cfg.get("lr_schedule")))
    return optimizer, scheduler


class EMA:
    """Exponential moving average of a module's parameters, held in a copy
    of the module (so the copy can run, fused kernels included). The
    update is in place: every parameter's ``_version`` moves, so weights
    packed from the copy are repacked. Buffers (BatchNorm's running
    statistics) are not averaged: the copy takes the module's own at every
    update, as the JAX package samples its EMA weights with the live
    ``batch_stats``."""

    def __init__(self, module, decay):
        self.decay = float(decay)
        self.module = copy.deepcopy(module).requires_grad_(False).eval()

    @torch.no_grad()
    def update(self, module):
        """ema = ema * decay + params * (1 - decay)."""
        ema = list(self.module.parameters())
        torch._foreach_mul_(ema, self.decay)
        torch._foreach_add_(ema, [p.detach() for p in module.parameters()],
                            alpha=1.0 - self.decay)
        for mine, live in zip(self.module.buffers(), module.buffers()):
            mine.copy_(live)

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict):
        self.module.load_state_dict(state_dict)
