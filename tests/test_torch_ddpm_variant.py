"""The discrete-t BatchNorm DDPM variant in the port against the JAX
package: the time encoding, the UNet in train and eval mode with flax's
BatchNorm rules, DDPMDiffusion's loss, step and interpolation, the weight
bridge with ``batch_stats`` both ways, and DDPMModel's train step, samples,
EMA and checkpoints on configs/sample_ddpm_16.json at a tiny width.

The JAX draws are rebuilt from the JAX keys as the JAX functions split
them and injected into the port (``t``, ``noise``, ``q_noise``,
``noise_seq``, ``x_init``). Dropout is 0 wherever the two are compared.

Tolerances: the encoding 1e-6; UNet forwards 1e-5; the BatchNorm running
statistics after a step 1e-6 relative (flax's update: the biased batch
variance, momentum 0.9); the loss 1e-5 relative; chains 1e-4 (f32
summation order through a few UNet calls); params after one Adam step
atol 0.05 lr, as ``test_torch_train.py`` holds them.
"""

import copy
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.diffusion import DDPMDiffusion as JDDPMDiffusion
from hsi_dmgasr_tpu.diffusion import DiffusionSchedule as JSchedule
from hsi_dmgasr_tpu.io.convert_torch import state_dict_to_flax
from hsi_dmgasr_tpu.models.unet import UNet as JUNet
from hsi_dmgasr_tpu.models.unet import discrete_time_encoding as j_encoding
from hsi_dmgasr_tpu.train import ddpm_model as j_ddpm_mod
from hsi_dmgasr_tpu_torch.config import load
from hsi_dmgasr_tpu_torch.diffusion import DDPMDiffusion
from hsi_dmgasr_tpu_torch.io.convert_torch import (export_jax_params, load_jax_params,
                                                   load_state_dict, unflatten)
from hsi_dmgasr_tpu_torch.models import unet as unet_mod
from hsi_dmgasr_tpu_torch.models.unet import UNet, discrete_time_encoding
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
from torch_port_weights import jax_variables, randomize

KW = dict(in_channel=3, out_channel=3, inner_channel=8, norm_groups=4, channel_mults=(1, 2),
          attn_res=(8,), res_blocks=1, image_size=16)
JKW = dict(KW, time_embedding="discrete", norm="batch")
PKW = dict(KW, time_embedding="discrete", norm="batch")
CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "sample_ddpm_16.json")
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_stats(module, seed):
    """BatchNorm running statistics away from their init (mean 0, var 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.3 * torch.randn(b.shape, generator=gen))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=gen))
    return module


@pytest.fixture(scope="module")
def ddpm_net():
    """The tiny BatchNorm UNet as (JAX module, its variables, port module)."""
    net = _random_stats(randomize(UNet(**PKW), 0), 1).eval()
    jnet = JUNet(**JKW)
    variables = jax_variables(jnet, net, np.zeros((1, 16, 16, 3), np.float32),
                              np.zeros((1,), np.int32))
    assert set(variables) == {"params", "batch_stats"}
    return jnet, variables, net


def _x_t(seed=2, b=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, 16, 16, 3).astype(np.float32),
            rng.randint(0, 50, (b,)).astype(np.int32))


def test_discrete_time_encoding_matches_jax():
    """1e-6 up to t = 255. Beyond, torch's and XLA's f32 exp differ by one
    ulp on a few frequencies (up to 1.9e-9), which t multiplies: t = 1999
    is held to 2e-9 t (measured 3.2e-6)."""
    for t, tol in ((np.arange(256, dtype=np.int32), 1e-6),
                   (np.array([0, 999, 1500, 1999], np.int32), 2e-9 * 1999)):
        for dim in (8, 64):
            np.testing.assert_allclose(discrete_time_encoding(torch.tensor(t), dim).numpy(),
                                       np.asarray(j_encoding(jnp.asarray(t), dim)), atol=tol)


def test_unet_eval_matches_flax(ddpm_net):
    jnet, variables, net = ddpm_net
    x, t = _x_t()
    want = jnet.apply(variables, x, t, train=False)
    with torch.no_grad():
        got = net(torch.tensor(x), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_unet_train_forward_and_running_stats_match_flax(ddpm_net):
    """Train mode: normalised by the batch, the running statistics moved
    by flax's rule (biased variance, momentum 0.9), not torch's."""
    jnet, variables, net = ddpm_net
    x, t = _x_t(3)
    want, upd = jnet.apply(variables, x, t, train=True, mutable=["batch_stats"])
    net = copy.deepcopy(net).train()
    with torch.no_grad():
        got = net(torch.tensor(x), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    stats = export_jax_params(net, "batch_stats")
    want_stats = {p: np.asarray(v) for p, v in _flat(upd["batch_stats"])}
    assert stats.keys() == want_stats.keys() and len(stats) > 10
    before = {p: np.asarray(v) for p, v in _flat(variables["batch_stats"])}
    for p, w in want_stats.items():
        assert not np.allclose(w, before[p]), p  # the step moved them
        np.testing.assert_allclose(stats[p], w, rtol=1e-6, atol=1e-7, err_msg="/".join(p))


def test_batchnorm_takes_the_biased_variance():
    """One BatchNorm step from var 1: 0.9 + 0.1 E[(x - mean)^2] (n, not n-1)."""
    bn = unet_mod.BatchNorm(4).train()
    x = torch.randn((2, 3, 3, 4), generator=torch.Generator().manual_seed(0))
    bn(x)
    var = x.reshape(-1, 4).var(0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.reshape(-1, 4).mean(0))
    assert int(bn.num_batches_tracked) == 1


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_fuse_flag_keeps_batchnorm_blocks_unfused(ddpm_net):
    """model.unet.fuse on the ddpm variant: no fused-kernel call (it is a
    GroupNorm kernel), the same output as the unfused module."""
    _, _, net = ddpm_net
    fused = UNet(**PKW, fuse_blocks=True).eval()
    fused.load_state_dict(net.state_dict())
    x, t = _x_t(4)

    def refuse(*a, **k):
        raise AssertionError("the fused GroupNorm kernel was called on a BatchNorm Block")

    with torch.no_grad(), mock.patch.object(unet_mod, "gn_swish_conv3x3", refuse):
        got = fused(torch.tensor(x), torch.tensor(t))
        want = net(torch.tensor(x), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ diffusion


def _sched(T=8):
    return JSchedule.create("linear", T, 1e-4, 2e-2)


def test_p_losses_matches_jax(ddpm_net):
    jnet, variables, net = ddpm_net
    sched = _sched(50)
    x, _ = _x_t(5)
    key = jax.random.PRNGKey(3)
    k_t, k_n = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (3,), 0, 50))
    noise = np.array(jax.random.normal(k_n, x.shape, jnp.float32))
    jd = JDDPMDiffusion(schedule=sched, conditional=False, loss_type="l2")
    want = float(jd.p_losses(lambda a, b: jnet.apply(variables, a, b), key, x))
    with torch.no_grad():
        got = float(DDPMDiffusion(sched, conditional=False, loss_type="l2").p_losses(
            net, torch.tensor(x), t=t, noise=noise))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("t", [0, 5])
def test_step_matches_jax(ddpm_net, t):
    jnet, variables, net = ddpm_net
    sched = _sched()
    x, _ = _x_t(6, b=2)
    noise = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    want = JDDPMDiffusion(schedule=sched, conditional=False)._step(
        lambda a, b: jnet.apply(variables, a, b), x, t, None, None, noise=noise)
    with torch.no_grad():
        got = DDPMDiffusion(sched, conditional=False)._step(net, torch.tensor(x), t, None,
                                                            noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("t,lam", [(None, 0.5), (4, 0.25)])
def test_interpolate_matches_jax(ddpm_net, t, lam):
    jnet, variables, net = ddpm_net
    sched = _sched()
    rng = np.random.RandomState(8)
    x1, x2 = (rng.randn(2, 16, 16, 3).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(5)
    want = JDDPMDiffusion(schedule=sched, conditional=False).interpolate(
        lambda a, b: jnet.apply(variables, a, b), key, x1, x2, t=t, lam=lam)
    tt = 7 if t is None else t
    k_q1, k_q2, k_steps = jax.random.split(key, 3)
    q_noise = [np.asarray(jax.random.normal(k, x1.shape, jnp.float32)) for k in (k_q1, k_q2)]
    noise_seq = np.stack([np.asarray(jax.random.normal(k, x1.shape, jnp.float32))
                          for k in jax.random.split(k_steps, tt)])
    with torch.no_grad():
        got = DDPMDiffusion(sched, conditional=False).interpolate(
            net, x1, x2, t=t, lam=lam, q_noise=q_noise, noise_seq=noise_seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ the bridge


def test_load_jax_params_round_trip_with_batch_stats(ddpm_net):
    _, variables, net = ddpm_net
    params = export_jax_params(net)
    stats = export_jax_params(net, "batch_stats")
    want = {c: dict(_flat(variables[c])) for c in ("params", "batch_stats")}
    assert params.keys() == want["params"].keys()
    assert stats.keys() == want["batch_stats"].keys()
    for p, v in stats.items():
        np.testing.assert_array_equal(v, want["batch_stats"][p], err_msg="/".join(p))
    dst = load_jax_params(UNet(**PKW), {"params": unflatten(params),
                                        "batch_stats": unflatten(stats)})
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(dst.state_dict()[k], v), k
    # and straight from the JAX package's own variables
    dst = load_jax_params(UNet(**PKW), jax.tree.map(np.asarray, variables))
    for k, v in net.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(dst.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    with pytest.raises(KeyError, match="batch_stats"):
        load_jax_params(UNet(**PKW), variables["params"])


def test_reference_bn_state_dict_loads(ddpm_net):
    """A reference-layout ddpm ``{prefix}_gen.pth`` state_dict
    (``denoise_fn.time_mlp.1``, ``...mlp.1``, ``block.0.running_mean``, ...):
    the JAX package's converter maps every key onto its UNet's tree, and
    the port loads it as it is."""
    _, _, net = ddpm_net
    sd = {"denoise_fn." + k: v.clone() for k, v in net.state_dict().items()}
    assert any(".mlp.1." in k for k in sd) and any(k.startswith("denoise_fn.time_mlp.1.")
                                                  for k in sd)
    assert any(k.endswith("block.0.running_var") for k in sd)
    jax_variables(JUNet(**JKW), net, np.zeros((1, 16, 16, 3), np.float32),
                  np.zeros((1,), np.int32))
    dst = load_state_dict(UNet(**PKW), sd)
    for k, v in net.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


# ------------------------------------------------------------ DDPMModel


def _opt(ema=True, T=6):
    """configs/sample_ddpm_16.json at a tiny UNet width and a short chain."""
    opt = load(CONFIG)
    opt["model"]["unet"].update(inner_channel=8, norm_groups=4, channel_multiplier=[1, 2],
                                attn_res=[8], res_blocks=1, dropout=0.0)
    opt["model"]["diffusion"]["image_size"] = 16
    for p in ("train", "val"):
        opt["model"]["beta_schedule"][p]["n_timestep"] = T
    opt["train"]["optimizer"]["lr"] = LR
    if ema:
        opt["train"]["ema_scheduler"] = {"ema_decay": 0.9, "use_ema_for_eval": True}
    return opt


def _models(opt, seed=4):
    ddpm = DDPMModel(opt, device="cpu")
    _random_stats(randomize(ddpm.unet, seed), seed + 1)
    variables = state_dict_to_flax({k: v.detach().numpy().copy()
                                    for k, v in ddpm.unet.state_dict().items()})
    with mock.patch.object(JUNet, "init", lambda self, *a, **k: variables), \
            mock.patch.object(j_ddpm_mod, "init_weights", lambda p, k, init_type: p):
        jm = j_ddpm_mod.DDPMModel(opt, seed=0)
    return ddpm, jm


def test_config_builds_the_ddpm_variant():
    ddpm = DDPMModel(_opt(), device="cpu")
    assert ddpm.discrete and isinstance(ddpm.val_diffusion, DDPMDiffusion)
    assert not ddpm.val_diffusion.conditional
    assert isinstance(ddpm.unet.final_conv.block[0], unet_mod.BatchNorm)
    assert ddpm.unet.noise_level_mlp is None and ddpm.unet.time_mlp is not None


def test_train_step_matches_jax():
    """One step on an unconditional batch ({"HR": x, "SR": None}, as
    cli/sample.py calls it): the loss, the gradients, the running
    statistics and the Adam-updated params against the JAX model's. A
    conv bias that feeds a BatchNorm has gradient 0 in exact arithmetic,
    so its f32 gradient is rounding noise: the gradients are held to 1e-4
    of the largest |g| of all leaves, and Adam's first step (lr times the
    gradient's sign) is compared where |g| is above 1e-6 of it."""
    opt = _opt(ema=False)
    ddpm, jm = _models(opt)
    hr = np.random.RandomState(9).randn(2, 16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    k_diff, k_drop = jax.random.split(key)
    k_t, k_n = jax.random.split(k_diff)
    t = np.array(jax.random.randint(k_t, (2,), 0, 6))
    noise = np.array(jax.random.normal(k_n, hr.shape, jnp.float32))

    def loss_fn(params):
        return jm.train_diffusion.p_losses(
            lambda x, tt: jm._denoise_apply(params, jm.state.batch_stats, x, tt, train=True,
                                            rngs={"dropout": k_drop})[0],
            k_diff, hr, None)

    jgrads = dict(_flat(jax.device_get(jax.jit(jax.grad(loss_fn))(jm.state.params))))
    want = float(jm.train_step({"HR": hr, "SR": None}, key))
    got = float(ddpm.compute_grads({"HR": hr, "SR": None}, t=t, noise=noise))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    holder = copy.deepcopy(ddpm.unet)  # the gradients in the weights' places
    with torch.no_grad():
        for mine, live in zip(holder.parameters(), ddpm.unet.parameters()):
            mine.copy_(live.grad)
    grads = export_jax_params(holder)
    assert grads.keys() == jgrads.keys()
    gmax = max(float(np.abs(g).max()) for g in jgrads.values())
    for path, w in jgrads.items():
        np.testing.assert_allclose(grads[path], w, rtol=1e-4, atol=1e-4 * gmax,
                                   err_msg="/".join(path))
    ddpm.apply_gradients()
    stats = export_jax_params(ddpm.unet, "batch_stats")
    want_stats = dict(_flat(jax.device_get(jm.state.batch_stats)))
    assert stats.keys() == want_stats.keys()
    for p, w in want_stats.items():
        np.testing.assert_allclose(stats[p], np.asarray(w), rtol=1e-6, atol=1e-7,
                                   err_msg="/".join(p))
    params = export_jax_params(ddpm.unet)
    for p, w in _flat(jax.device_get(jm.state.params)):
        defined = np.abs(jgrads[p]) > 1e-6 * gmax
        np.testing.assert_allclose(params[p][defined], np.asarray(w)[defined], rtol=0,
                                   atol=0.05 * LR, err_msg="/".join(p))
    with pytest.raises(ValueError, match="gamma"):
        ddpm.compute_grads({"HR": hr, "SR": None}, gamma=np.ones(2, np.float32))


def test_sample_matches_jax():
    """DDPMModel.sample on the EMA weights with the running statistics."""
    ddpm, jm = _models(_opt())
    key, shape = jax.random.PRNGKey(6), (2, 16, 16, 3)
    want = np.asarray(jm.sample(batch_size=2, key=key))
    k_init, k_steps = jax.random.split(key)
    x_init = np.array(jax.random.normal(k_init, shape, jnp.float32))
    noise = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                      for k in jax.random.split(k_steps, 6)])
    got = ddpm.sample(2, x_init=x_init, noise_seq=noise)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_ema_and_checkpoints_carry_the_running_stats(tmp_path):
    ddpm = DDPMModel(_opt(), device="cpu")
    hr = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    ddpm.train_step({"HR": hr, "SR": None}, generator=torch.Generator().manual_seed(1))
    live = dict(ddpm.unet.named_buffers())
    assert float(live["final_conv.block.0.num_batches_tracked"]) == 1
    for name, b in ddpm.ema.module.named_buffers():
        assert torch.equal(b, live[name]), name  # the EMA samples with the live stats
    path = ddpm.save_checkpoint(str(tmp_path), 1, 1)
    back = DDPMModel(_opt(), seed=5, device="cpu")
    back.load_checkpoint(path)
    for module, want in ((back.unet, ddpm.unet), (back.ema.module, ddpm.ema.module)):
        for k, v in want.state_dict().items():
            assert torch.equal(module.state_dict()[k], v), k
    npz = ddpm.export_params_npz(str(tmp_path / "eval.npz"), dtype=np.float32)
    with np.load(npz) as z:
        assert any(k.startswith("batch_stats/") for k in z.files)
    fresh = DDPMModel(_opt(), seed=6, device="cpu")
    fresh.load_params_npz(npz)
    for k, v in ddpm.eval_unet.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.unet.state_dict()[k], v), k
