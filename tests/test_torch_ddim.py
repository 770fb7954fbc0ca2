"""The port's DDIM sampler, its unconditional chains and the reverse-process
stacks against the JAX package.

The JAX draws are rebuilt here from the JAX keys, as the JAX functions
split them, and injected into the port (``x_init``, ``noise_seq``):
``ddim_sample_loop`` splits its key into (k_init, k_steps), draws x_T from
k_init and step i's noise from ``split(k_steps, len(ts))[i]``;
``sample_loop`` does the same with one key per ancestral step. The JAX
``DDPMModel``s are built with the port's weights in place of their
``unet.init`` and orthogonal re-init, as in ``test_torch_train.py``.

Tolerances: every chain atol = rtol = 1e-4, the ancestral chain's
(``test_torch_diffusion.py``): f32 summation order through a few UNet
calls; the stacks frame for frame at the same 1e-4.
"""

import copy
import functools
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.diffusion import DiffusionSchedule as JSchedule
from hsi_dmgasr_tpu.diffusion import GaussianDiffusion as JDiffusion
from hsi_dmgasr_tpu.io.convert_torch import state_dict_to_flax
from hsi_dmgasr_tpu.models import GAE as JGAE
from hsi_dmgasr_tpu.models.networks import define_G as j_define_G
from hsi_dmgasr_tpu.models.networks import diffusion_for_phase as j_diffusion
from hsi_dmgasr_tpu.models.unet import UNet as JUNet
from hsi_dmgasr_tpu.pipeline import DMGASRPipeline as JPipeline
from hsi_dmgasr_tpu.train import ddpm_model as j_ddpm_mod
from hsi_dmgasr_tpu_torch.config import load
from hsi_dmgasr_tpu_torch.diffusion import GaussianDiffusion
from hsi_dmgasr_tpu_torch.io.convert_torch import load_jax_params
from hsi_dmgasr_tpu_torch.models.gae import GAE
from hsi_dmgasr_tpu_torch.models.unet import UNet
from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
from torch_port_weights import jax_variables, randomize

TOL = 1e-4
KW = dict(out_channel=3, inner_channel=8, norm_groups=4, channel_mults=(1, 2), attn_res=(8,),
          res_blocks=1, image_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    """A conditional (6 input channels) and an unconditional (3) tiny UNet,
    each as (JAX apply fn, port module) on the same weights."""
    out = {}
    for name, cin, seed in (("cond", 6, 0), ("uncond", 3, 1)):
        net = randomize(UNet(in_channel=cin, **KW), seed).eval()
        jnet = JUNet(in_channel=cin, **KW)
        v = jax_variables(jnet, net, np.zeros((1, 16, 16, cin), np.float32),
                          np.zeros((1, 1), np.float32))
        out[name] = (jax.jit(lambda x, t, v=v, jnet=jnet: jnet.apply(v, x, t)), net)
    return out


def _draws(key, shape, n):
    """(x_init, noise per step) of a JAX chain under ``key``."""
    k_init, k_steps = jax.random.split(key)
    x_init = np.array(jax.random.normal(k_init, shape, jnp.float32))
    noise = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                      for k in jax.random.split(k_steps, n)])
    return x_init, noise


def _cond(seed=3, b=2):
    return np.random.RandomState(seed).randn(b, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize("steps", [None, 4, 5])
@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_matches_jax(nets, eta, steps):
    jdn, net = nets["cond"]
    sched = JSchedule.create("cosine", 10, 1e-6, 1e-2)
    cond, key = _cond(), jax.random.PRNGKey(7)
    want = JDiffusion(schedule=sched).ddim_sample_loop(jdn, key, cond=cond, steps=steps, eta=eta)
    gd = GaussianDiffusion(sched)
    x_init, noise = _draws(key, cond.shape, len(gd.ddim_timesteps(steps)))
    with torch.no_grad():
        got = gd.ddim_sample_loop(net, cond=torch.tensor(cond), steps=steps, eta=eta,
                                  x_init=x_init, noise_seq=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_ddim_unconditional_matches_jax(nets):
    jdn, net = nets["uncond"]
    sched = JSchedule.create("linear", 12, 1e-4, 2e-2)
    key, shape = jax.random.PRNGKey(2), (2, 16, 16, 3)
    want = JDiffusion(schedule=sched).ddim_sample_loop(jdn, key, shape=shape, steps=5, eta=0.5)
    x_init, noise = _draws(key, shape, 5)
    with torch.no_grad():
        got = GaussianDiffusion(sched).ddim_sample_loop(net, shape=shape, steps=5, eta=0.5,
                                                        x_init=x_init, noise_seq=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_ddim_timesteps_round_half_to_even():
    """linspace(0, T-1, steps), numpy's half-to-even rounding, T-1 first."""
    gd = GaussianDiffusion(JSchedule.create("cosine", 4, 1e-6, 1e-2))
    assert gd.ddim_timesteps(3).tolist() == [3, 2, 0]  # 1.5 -> 2
    gd = GaussianDiffusion(JSchedule.create("cosine", 20, 1e-6, 1e-2))
    assert gd.ddim_timesteps(4).tolist() == [19, 13, 6, 0]
    assert gd.ddim_timesteps(None).tolist() == list(range(19, -1, -1))


def test_ddim_draws_from_the_generator(nets):
    """eta > 0 without replay: a function of the generator's seed."""
    net = nets["cond"][1]
    gd = GaussianDiffusion(JSchedule.create("cosine", 10, 1e-6, 1e-2))
    cond = torch.tensor(_cond())
    with torch.no_grad():
        a, b, c = (gd.ddim_sample_loop(net, cond=cond, steps=4, eta=0.5,
                                       generator=torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.allclose(a, c)


@pytest.mark.parametrize("return_intermediates", [False, True])
def test_unconditional_sample_loop_matches_jax(nets, return_intermediates):
    jdn, net = nets["uncond"]
    sched = JSchedule.create("linear", 6, 1e-4, 2e-2)
    shape, key = (2, 16, 16, 3), jax.random.PRNGKey(4)
    x_init, noise = _draws(key, shape, 6)
    want = JDiffusion(schedule=sched, conditional=False).sample_loop(
        jdn, key, shape=shape, x_init=x_init, noise_seq=noise,
        return_intermediates=return_intermediates)
    with torch.no_grad():
        got = GaussianDiffusion(sched, conditional=False).sample_loop(
            net, shape=shape, x_init=x_init, noise_seq=noise,
            return_intermediates=return_intermediates)
    if return_intermediates:
        (got, got_inter), (want, want_inter) = got, want
        assert got_inter.shape == (6, *shape)
        np.testing.assert_allclose(got_inter.numpy(), np.asarray(want_inter), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


# ------------------------------------------------------------ DDPMModel


def _opt(conditional=True, T=20, **diffusion):
    """The DDIM config of tests/test_ddim.py:40 (sampler and steps given by
    ``diffusion``); unconditional: 3 input channels."""
    return {
        "name": "ddim", "gpu_ids": [0],
        "model": {
            "which_model_G": "sr3",
            "unet": {"in_channel": 6 if conditional else 3, "out_channel": 3,
                     "inner_channel": 8, "norm_groups": 4, "channel_multiplier": [1, 2],
                     "attn_res": [8], "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {p: {"schedule": "cosine", "n_timestep": T,
                                  "linear_start": 1e-6, "linear_end": 1e-2}
                              for p in ("train", "val")},
            "diffusion": {"image_size": 16, "channels": 3, "conditional": conditional,
                          **diffusion},
        },
        "train": {"optimizer": {"lr": 1e-4}}, "path": {},
    }


def _models(opt, seed=5):
    """(port DDPMModel, JAX DDPMModel) on the same seeded weights."""
    ddpm = DDPMModel(opt, device="cpu")
    randomize(ddpm.unet, seed)
    variables = state_dict_to_flax({k: v.detach().numpy().copy()
                                    for k, v in ddpm.unet.state_dict().items()})
    with mock.patch.object(JUNet, "init", lambda self, *a, **k: variables), \
            mock.patch.object(j_ddpm_mod, "init_weights", lambda p, k, init_type: p):
        jm = j_ddpm_mod.DDPMModel(opt, seed=0)
    return ddpm, jm


def test_ddpm_model_ddim_config_matches_jax():
    opt = _opt(sampler="ddim", ddim_steps=4)
    ddpm, jm = _models(opt)
    cond, key = _cond(b=1), jax.random.PRNGKey(0)
    want = jm.super_resolution(cond, key=key)
    x_init, noise = _draws(key, cond.shape, 4)
    got = ddpm.super_resolution(cond, x_init=x_init, noise_seq=noise)
    assert got.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_t_start_with_ddim_is_refused_as_in_jax():
    opt = _opt(sampler="ddim", ddim_steps=4, t_start=2)
    ddpm, jm = _models(opt)
    cond = _cond(b=1)
    msg = "t_start requires conditional ancestral sampling"
    with pytest.raises(ValueError, match=msg):
        jm.super_resolution(cond, key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match=msg):
        ddpm.super_resolution(cond)


def test_unknown_sampler_is_refused():
    with pytest.raises(ValueError, match="sampler"):
        DDPMModel(_opt(sampler="euler"), device="cpu").super_resolution(_cond(b=1))


@pytest.mark.parametrize("continous", [False, True])
def test_sample_matches_jax(continous):
    """Unconditional DDPMModel.sample, the final state or the stack seeded
    from the initial noise (T = 20: every third step is kept)."""
    ddpm, jm = _models(_opt(conditional=False), seed=6)
    key, shape = jax.random.PRNGKey(3), (2, 16, 16, 3)
    want = np.asarray(jm.sample(batch_size=2, key=key, continous=continous))
    x_init, noise = _draws(key, shape, 20)
    got = ddpm.sample(2, x_init=x_init, noise_seq=noise, continous=continous).numpy()
    assert got.shape == want.shape == (((1 + 7) * 2,) if continous else (2,)) + shape[1:]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    if continous:
        np.testing.assert_array_equal(got[:2], x_init)


def test_sample_refuses_a_conditional_config():
    with pytest.raises(ValueError, match="unconditional config"):
        DDPMModel(_opt(), device="cpu").sample(1)


@pytest.mark.parametrize("t_start", [None, 3])
def test_super_resolution_stack_matches_jax(t_start):
    """super_resolution(continous=True): the conditioning, then the kept
    states; with t_start, x_init is init_from_cond under the chain's own
    k_init."""
    diffusion = {} if t_start is None else {"t_start": t_start}
    ddpm, jm = _models(_opt(T=10, **diffusion), seed=7)
    cond, key = _cond(b=2), jax.random.PRNGKey(9)
    want = np.asarray(jm.super_resolution(cond, key=key, continous=True))
    n = 10 if t_start is None else t_start
    x_init, noise = _draws(key, cond.shape, n)
    if t_start is not None:
        k_init, _ = jax.random.split(key)
        x_init = np.asarray(jm.val_diffusion.init_from_cond(cond, k_init, t_start))
    got = ddpm.super_resolution(cond, x_init=x_init, noise_seq=noise, continous=True).numpy()
    assert got.shape == want.shape == ((1 + n) * 2, 16, 16, 3)
    np.testing.assert_array_equal(got[:2], cond)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_continous_draws_x_init_as_the_chain_would():
    """Without replay, the stack's last frame is the state the plain call
    reaches from the same generator seed."""
    ddpm = DDPMModel(_opt(conditional=False, T=6), device="cpu")
    last = ddpm.sample(2, generator=torch.Generator().manual_seed(3), continous=True)[-2:]
    plain = ddpm.sample(2, generator=torch.Generator().manual_seed(3))
    assert torch.equal(last, plain)


# ------------------------------------------------------------ the slice


GAE_CFG = {"n_subs": 8, "n_ovls": 2, "n_colors": 31, "n_feats": 16, "G": 5}
GAE_KW = {k: GAE_CFG[k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")}


def _pavia_ddim_opt():
    """configs/pavia_x4_r3.json's diffusion and latent affine with the
    sampler switched to DDIM (its t_start removed: the JAX package refuses
    it with DDIM), at a tiny UNet width."""
    cfg = load(__file__.rsplit("/", 2)[0] + "/configs/pavia_x4_r3.json")
    opt = copy.deepcopy(_opt(T=cfg["model"]["beta_schedule"]["val"]["n_timestep"],
                             sampler="ddim", ddim_steps=4))
    opt["model"]["beta_schedule"] = cfg["model"]["beta_schedule"]
    opt["gae"] = {k: cfg["gae"][k] for k in ("latent_shift", "latent_scale")}
    assert "t_start" in cfg["model"]["diffusion"]
    return opt


def test_pipeline_ddim_with_replay_matches_jax():
    """DMGASRPipeline.super_resolve under the DDIM config passes x_init and
    noise_seq through to the DDIM chain: the cube against the JAX
    pipeline's encode -> ddim_sample_loop -> decode on the same draws."""
    opt = _pavia_ddim_opt()
    rng = np.random.RandomState(0)
    sr = rng.rand(1, 16, 16, 31).astype(np.float32)
    gae = randomize(GAE(**GAE_KW), 1)
    gae_vars = jax_variables(JGAE(**GAE_KW), gae, np.zeros((1, 16, 16, 31), np.float32))
    ddpm = DDPMModel(opt, device="cpu")
    randomize(ddpm.unet, 2)
    junet, _ = j_define_G(opt)
    unet_vars = jax_variables(junet, ddpm.unet, np.zeros((1, 16, 16, 6), np.float32),
                              np.zeros((1, 1), np.float32))
    jd = j_diffusion(opt, "val")
    jpipe = JPipeline(opt, gae_vars, GAE_CFG, ddpm=SimpleNamespace(
        unet=junet, variables=unet_vars, val_diffusion=jd))
    pipe = DMGASRPipeline(opt, gae.state_dict(), GAE_CFG,
                          ddpm=ddpm, device="cpu")
    load_jax_params(ddpm.unet, unet_vars)
    cond = jpipe._fold(jpipe.encode(sr))
    key = jax.random.PRNGKey(1)
    z = jd.ddim_sample_loop(functools.partial(junet.apply, unet_vars), key, cond=cond, steps=4)
    want = np.clip(np.asarray(jpipe.decode(jpipe._unfold(z, 1))), 0, 1)
    x_init, noise = _draws(key, cond.shape, 4)
    got = pipe.super_resolve(sr, x_init=x_init, noise_seq=noise)
    assert got.shape == (1, 16, 16, 31)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_sr_sr3_16_128_config_matches_jax():
    """configs/sr_sr3_16_128.json (the legacy face SR3, EMA configured) at
    a tiny UNet width and a 6-step chain: the ancestral super_resolution
    against the JAX model's on the same draws."""
    opt = load(__file__.rsplit("/", 2)[0] + "/configs/sr_sr3_16_128.json")
    opt["model"]["unet"].update(inner_channel=8, norm_groups=4, channel_multiplier=[1, 2],
                                attn_res=[8], res_blocks=1, dropout=0.0)
    opt["model"]["diffusion"]["image_size"] = 16
    for p in ("train", "val"):
        opt["model"]["beta_schedule"][p]["n_timestep"] = 6
    ddpm, jm = _models(opt, seed=8)
    cond, key = _cond(b=1), jax.random.PRNGKey(12)
    want = jm.super_resolution(cond, key=key)
    x_init, noise = _draws(key, cond.shape, 6)
    got = ddpm.super_resolution(cond, x_init=x_init, noise_seq=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
