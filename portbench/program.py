"""The system under test: the PyTorch + CUDA port's DMGASR pipeline, built
from a configuration file of the benchmark and the state_dicts the
benchmark made.

Which modules of the harness may import the program (the tests hold
these rules): ``reference/`` imports nothing of it, and neither does the
tests' tiny derivation (``tests/tiny.py``), so a kind imports it only
inside its functions; the kinds (``kinds/``), this module and the metric
readers (``metrics/``, e.g. ``fused_wgmma_share.cube.py``) may, and do."""

from __future__ import annotations

import copy


def gae_config(cfg):
    """The GAE widths of a configuration, with its number of band groups."""
    g = dict(cfg["gae_widths"])
    g["G"] = -(-(g["n_colors"] - g["n_ovls"]) // (g["n_subs"] - g["n_ovls"]))
    return g


def build(cfg, gae_state, unet_state, device):
    """A ``DMGASRPipeline`` of the configuration, f32 with TF32 off (the
    port's own policy), its GAE and UNet loaded from the given
    reference-layout state_dicts."""
    from hsi_dmgasr_tpu_torch.config import dict_to_nonedict
    from hsi_dmgasr_tpu_torch.device import use_f32_policy
    from hsi_dmgasr_tpu_torch.io.convert_torch import load_state_dict
    from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline

    use_f32_policy()
    opt = dict_to_nonedict({k: copy.deepcopy(cfg[k]) for k in ("model", "gae", "train")})
    pipe = DMGASRPipeline(opt, gae_state, gae_config(cfg), seed=0, device=device)
    load_state_dict(pipe.ddpm.unet, unet_state)
    return pipe


def scene_cache(scenes, crop, device):
    """The stage-2 driver's device-resident scenes (``DeviceSceneCache``),
    from (S, H, W, C) normalised scenes, sampling crops of ``crop``^2."""
    from hsi_dmgasr_tpu_torch.data.device_cache import DeviceSceneCache

    return DeviceSceneCache([s.cpu().numpy() for s in scenes], crop, device=device)


def launches():
    """The port's kernel launch counters: {kernel: launches so far}."""
    from hsi_dmgasr_tpu_torch.kernels import blocked_dot, flash_attention, fused_conv

    return {"fused_block": fused_conv.LAUNCHES, "flash": flash_attention.LAUNCHES,
            "blocked_dot": blocked_dot.LAUNCHES}
