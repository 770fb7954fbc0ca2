"""The whole slice: GAE encode -> latent affine -> replayed reverse chain
at t_start -> GAE decode -> metrics, port against the JAX package.

Tiny settings in the shape of tests/test_pipeline.py's TINY_OPT, the
latent affine of configs/pavia_x4_r3.json and t_start set. Both sides
get the same seeded weights (through the bridge) and the same x_init and
noise; the JAX side runs its pipeline's encode/decode and its sampler
over the UNet that its ``define_G`` builds from the same config.

Tolerances: unfused (f32 end to end) 1e-4 on the cube and on the metric
dict (relative); fused 3e-2 on the cube, the JAX package's fused-UNet
tolerance, with the metric dict then held to 1e-2 relative.

A second case has the shape of configs/pavia_x4.json: no t_start, no
latent affine, the full (short) chain, and attention on the flash path on
both sides. Its Blocks are the f32 ones, so the case isolates the
attention route: from pure noise the bf16 fused Blocks alone move the JAX
package's own cube past the fused tolerance against its f32 Blocks here,
so no tolerance of the port could tell that drift from a fault.
Tolerance 5e-3, the flash function's, for its bf16 operand rounding
(1.3e-3 on this seed, where the cube is typically 0.19).
"""

import functools
import os
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hsi_dmgasr_tpu.config import load_json_with_comments as j_load_json
from hsi_dmgasr_tpu.kernels import attention as j_attention
from hsi_dmgasr_tpu.evalhsi import quality_assessment_jax
from hsi_dmgasr_tpu.models import GAE as JGAE
from hsi_dmgasr_tpu.models.networks import define_G as j_define_G
from hsi_dmgasr_tpu.models.networks import diffusion_for_phase as j_diffusion
from hsi_dmgasr_tpu.pipeline import DMGASRPipeline as JPipeline
from hsi_dmgasr_tpu_torch.config import load, load_json_with_comments
from hsi_dmgasr_tpu_torch.evalhsi.torch_metrics import quality_assessment_torch
from hsi_dmgasr_tpu_torch.io.convert_torch import load_jax_params
from hsi_dmgasr_tpu_torch.kernels import attention
from hsi_dmgasr_tpu_torch.models import unet as unet_mod
from hsi_dmgasr_tpu_torch.models.gae import GAE
from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
from torch_port_weights import jax_variables, randomize

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "pavia_x4_r3.json")
GAE_CFG = {"n_subs": 8, "n_ovls": 2, "n_colors": 31, "n_feats": 16, "G": 5}


def _opt(fuse):
    gae = load(CONFIG)["gae"]
    return {
        "gpu_ids": [0],
        "gae": {"latent_shift": gae["latent_shift"], "latent_scale": gae["latent_scale"]},
        "model": {
            "which_model_G": "sr3",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 32,
                     "norm_groups": 8, "channel_multiplier": [1, 2], "attn_res": [8],
                     "res_blocks": 1, "dropout": 0.0, "fuse": fuse},
            "beta_schedule": {p: {"schedule": "cosine", "n_timestep": 6,
                                  "linear_start": 1e-6, "linear_end": 1e-2}
                              for p in ("train", "val")},
            "diffusion": {"image_size": 16, "channels": 3, "conditional": True,
                          "t_start": 3},
        },
        "train": {"optimizer": {"type": "adam", "lr": 1e-4}},
        "path": {},
    }


@pytest.fixture(scope="module")
def cubes():
    rng = np.random.RandomState(0)
    hr = rng.rand(1, 16, 16, 31).astype(np.float32)
    sr = np.clip(hr + 0.05 * rng.randn(*hr.shape), 0, 1).astype(np.float32)
    x_init = rng.randn(5, 16, 16, 3).astype(np.float32)
    noise = rng.randn(6, 5, 16, 16, 3).astype(np.float32)
    return sr, hr, x_init, noise


GAE_KW = {k: GAE_CFG[k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")}


@pytest.fixture(scope="module")
def weights():
    """Seeded GAE and UNet weights, as port state_dicts and JAX variables."""
    gae = randomize(GAE(**GAE_KW), 1)
    gae_vars = jax_variables(JGAE(**GAE_KW), gae, np.zeros((1, 16, 16, 31), np.float32))
    unet = randomize(DDPMModel(_opt(False), device="cpu").unet, 2)
    junet, _ = j_define_G(_opt(False))
    unet_vars = jax_variables(junet, unet, np.zeros((1, 16, 16, 6), np.float32),
                              np.zeros((1, 1), np.float32))
    return gae.state_dict(), gae_vars, unet_vars


def _pipelines(weights, fuse):
    gae_sd, gae_vars, unet_vars = weights
    opt = _opt(fuse)
    junet, _ = j_define_G(opt)
    jpipe = JPipeline(opt, gae_vars, GAE_CFG, ddpm=SimpleNamespace(
        unet=junet, variables=unet_vars, val_diffusion=j_diffusion(opt, "val")))
    ddpm = DDPMModel(opt, device="cpu")
    load_jax_params(ddpm.unet, unet_vars)
    return jpipe, DMGASRPipeline(opt, gae_sd, GAE_CFG, ddpm=ddpm, device="cpu")


def _jax_replay(jpipe, sr, x_init, noise, t_start=3):
    d = jpipe.ddpm
    cond = jpipe._fold(jpipe.encode(sr))
    z = d.val_diffusion.sample_loop(
        lambda x, t: d.unet.apply(d.variables, x, t), jax.random.PRNGKey(0), cond=cond,
        x_init=x_init, noise_seq=noise, t_start=t_start)
    return np.clip(np.asarray(jpipe.decode(jpipe._unfold(z, sr.shape[0]))), 0, 1)


@pytest.mark.parametrize("fuse,tol,mtol", [(False, 1e-4, 1e-4), (True, 3e-2, 1e-2)])
def test_slice_matches_jax(cubes, weights, fuse, tol, mtol):
    sr, hr, x_init, noise = cubes
    jpipe, pipe = _pipelines(weights, fuse)
    np.testing.assert_allclose(pipe.encode(sr).numpy(), np.asarray(jpipe.encode(sr)),
                               atol=2e-5, rtol=2e-5)
    want = _jax_replay(jpipe, sr, x_init, noise)
    metrics, pred, secs = pipe.evaluate(sr, hr, x_init=x_init, noise_seq=noise)
    assert pred.shape == (1, 16, 16, 31) and secs > 0
    np.testing.assert_allclose(pred, want, atol=tol, rtol=tol)
    want_m = {k: float(v) for k, v in quality_assessment_jax(hr[0], want[0]).items()}
    assert metrics.keys() == want_m.keys()
    for k in want_m:
        np.testing.assert_allclose(metrics[k], want_m[k], rtol=mtol, atol=mtol, err_msg=k)
    host, _, _ = pipe.evaluate(sr, hr, x_init=x_init, noise_seq=noise, on_device=False)
    for k in want_m:
        np.testing.assert_allclose(host[k], metrics[k], rtol=1e-4, err_msg=k)


def _x4_opt(steps):
    """configs/pavia_x4.json's schema, narrow: no t_start, no latent
    affine. image_size 16 under a 32x32 cube puts attn_res [8] on the
    16^2 level, where mults [1, 4] make D = 128, and the mid block sits
    there too: 4 attention layers per forward, 256 tokens each."""
    opt = _opt(False)
    opt["gae"] = {}
    opt["model"]["unet"]["channel_multiplier"] = [1, 4]
    for phase in ("train", "val"):
        opt["model"]["beta_schedule"][phase]["n_timestep"] = steps
    del opt["model"]["diffusion"]["t_start"]
    return opt


def test_full_chain_with_flash_attention_matches_jax(monkeypatch):
    """Attention through the flash function on both sides: the JAX
    package's Pallas kernel in interpret mode (force_pallas), the port's
    plain version (force_flash)."""
    steps = 3
    rng = np.random.RandomState(5)
    hr = rng.rand(1, 32, 32, 31).astype(np.float32)
    sr = np.clip(hr + 0.05 * rng.randn(*hr.shape), 0, 1).astype(np.float32)
    x_init = rng.randn(5, 32, 32, 3).astype(np.float32)
    noise = rng.randn(steps, 5, 32, 32, 3).astype(np.float32)
    opt = _x4_opt(steps)
    gae = randomize(GAE(**GAE_KW), 1)
    gae_vars = jax_variables(JGAE(**GAE_KW), gae, np.zeros((1, 32, 32, 31), np.float32))
    ddpm = DDPMModel(opt, device="cpu")
    randomize(ddpm.unet, 2)
    junet, _ = j_define_G(opt)
    unet_vars = jax_variables(junet, ddpm.unet, np.zeros((1, 32, 32, 6), np.float32),
                              np.zeros((1, 1), np.float32))
    jpipe = JPipeline(opt, gae_vars, GAE_CFG, ddpm=SimpleNamespace(
        unet=junet, variables=unet_vars, val_diffusion=j_diffusion(opt, "val")))
    pipe = DMGASRPipeline(opt, gae.state_dict(), GAE_CFG, ddpm=ddpm, device="cpu")
    assert pipe.latent_shift == 0.0 and pipe.latent_scale == 1.0

    monkeypatch.setattr(j_attention, "spatial_attention",
                        functools.partial(j_attention.spatial_attention, force_pallas=True))
    with pltpu.force_tpu_interpret_mode():
        want = _jax_replay(jpipe, sr, x_init, noise, t_start=None)
    monkeypatch.setattr(unet_mod, "spatial_attention",
                        functools.partial(attention.spatial_attention, force_flash=True))
    with mock.patch.object(attention, "flash_attention", wraps=attention.flash_attention) as spy:
        got = pipe.super_resolve(sr, x_init=x_init, noise_seq=noise).numpy()
    assert spy.call_count == 4 * steps
    assert got.shape == (1, 32, 32, 31)
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


def test_torch_metrics_match_jax():
    """On-device metrics vs evalhsi/jax_metrics.py: f32, 1e-5 relative."""
    rng = np.random.RandomState(4)
    gt = rng.rand(20, 24, 7).astype(np.float32)
    y = np.clip(gt + 0.1 * rng.randn(*gt.shape), 0, 1).astype(np.float32)
    got = quality_assessment_torch(torch.tensor(gt), torch.tensor(y), 1.0, 4)
    want = quality_assessment_jax(gt, y, data_range=1.0, ratio=4)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_super_resolve_seeded_and_in_range(cubes, weights):
    sr = cubes[0]
    _, pipe = _pipelines(weights, False)
    y1 = pipe.super_resolve(sr, generator=torch.Generator().manual_seed(3))
    y2 = pipe.super_resolve(sr, generator=torch.Generator().manual_seed(3))
    assert y1.shape == (1, 16, 16, 31)
    assert float(y1.min()) >= 0.0 and float(y1.max()) <= 1.0
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    rec = pipe.reconstruct(sr)
    assert rec.shape == sr.shape


def test_config_reads_like_jax():
    assert load_json_with_comments(CONFIG) == j_load_json(CONFIG)
    opt = load(CONFIG)
    assert opt["model"]["diffusion"]["t_start"] == 4 and opt["missing"] is None
