"""Stage-2 training in the port against the JAX package: p_losses, the
Adam step with its lr schedule and EMA, finetune_norm, the orthogonal
init, checkpoints, the .npz export both ways, and one step of the whole
slice (degrade -> GAE encode -> UNet step).

The JAX draws (t, gamma, noise) are reproduced here from the JAX key
split (``gaussian.py:81-88`` inside ``ddpm_model.py:160-161``'s split)
and injected into the port, which otherwise draws from a torch
generator. Dropout is 0 wherever the two are compared.

The JAX DDPMModel's own eager init costs about a minute on the CPU, so
``_jax_ddpm`` builds it with the port's weights in place of its
``unet.init`` and of its orthogonal re-init; the rest of its __init__
(optax, EMA, mesh) runs as it is.

Tolerances: the loss 1e-5 relative; gradients rtol 1e-4 (atol 1e-4 of
the leaf's largest |g|); params and EMA after three Adam steps atol
0.05 lr; the lr schedules rtol 1e-7, against optax evaluated in f64 (in
f32 its cosine is up to 5.6e-7 relative from the exact value on
configs/pavia_x4_r3.json's schedule).
"""

import copy
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hsi_dmgasr_tpu.data.imresize import make_imresize_jax
from hsi_dmgasr_tpu.io.convert_torch import state_dict_to_flax
from hsi_dmgasr_tpu.models import GAE as JGAE
from hsi_dmgasr_tpu.models.networks import diffusion_for_phase as j_diffusion_for_phase
from hsi_dmgasr_tpu.models.networks import init_weights as j_init_weights
from hsi_dmgasr_tpu.models.unet import UNet as JUNet
from hsi_dmgasr_tpu.pipeline import DMGASRPipeline as JPipeline
from hsi_dmgasr_tpu.train import ddpm_model as j_ddpm_mod
from hsi_dmgasr_tpu_torch.io.convert_torch import (export_jax_params, load_jax_params,
                                                   unflatten)
from hsi_dmgasr_tpu_torch.models.gae import GAE
from hsi_dmgasr_tpu_torch.models.networks import diffusion_for_phase, init_weights
from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
from hsi_dmgasr_tpu_torch.train.state import lr_factor
from torch_port_weights import jax_variables, randomize


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's thread pool only spins against the other test
    workers of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LR = 1e-3


def _opt(dropout=0.0, ema=True, finetune=False, loss_type=None, loss_weight=None,
         sched=None):
    opt = {
        "gpu_ids": [0],
        "model": {
            "which_model_G": "sr3", "finetune_norm": finetune,
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8, "norm_groups": 4,
                     "channel_multiplier": [1, 2], "attn_res": [8], "res_blocks": 1,
                     "dropout": dropout},
            "beta_schedule": {p: {"schedule": "cosine", "n_timestep": 4,
                                  "linear_start": 1e-6, "linear_end": 1e-2}
                              for p in ("train", "val")},
            "diffusion": {"image_size": 16, "channels": 3, "conditional": True},
        },
        "train": {"optimizer": {"type": "adam", "lr": LR}},
        "path": {},
    }
    if sched:
        opt["train"]["optimizer"]["lr_schedule"] = sched
    if ema:
        opt["train"]["ema_scheduler"] = {"step_start_ema": 2, "update_ema_every": 3,
                                         "ema_decay": 0.9, "use_ema_for_eval": True}
    if loss_type:
        opt["model"]["loss_type"] = loss_type
    if loss_weight:
        opt["model"]["diffusion"]["loss_weight"] = loss_weight
    return opt


UNET_EX = (np.zeros((1, 16, 16, 6), np.float32), np.zeros((1, 1), np.float32))


def _jax_ddpm(opt, port_unet):
    """The JAX DDPMModel built from ``opt`` with the port UNet's weights."""
    # copies: on the CPU, JAX may alias a numpy buffer that the port's
    # optimizer later updates in place
    variables = state_dict_to_flax({k: v.detach().numpy().copy() for k, v in
                                    port_unet.state_dict().items()})
    with mock.patch.object(JUNet, "init", lambda self, *a, **k: variables), \
            mock.patch.object(j_ddpm_mod, "init_weights", lambda p, k, init_type: p):
        return j_ddpm_mod.DDPMModel(opt, seed=0)


def _draws(diffusion, key, shape):
    """(gamma, noise) of the JAX train step under ``key``."""
    k_diff, _ = jax.random.split(key)
    k_t, k_g, k_n = jax.random.split(k_diff, 3)
    sched = diffusion.schedule
    t = jax.random.randint(k_t, (), 1, sched.num_timesteps + 1)
    sacp = jnp.asarray(sched.sqrt_alphas_cumprod_prev, jnp.float32)
    gamma = jax.random.uniform(k_g, (shape[0],), jnp.float32, 0.0, 1.0) * (
        sacp[t] - sacp[t - 1]) + sacp[t - 1]
    return np.asarray(gamma), np.asarray(jax.random.normal(k_n, shape, jnp.float32))


def _batch(seed, b=2, hw=16):
    rng = np.random.RandomState(seed)
    return {"HR": rng.randn(b, hw, hw, 3).astype(np.float32),
            "SR": rng.randn(b, hw, hw, 3).astype(np.float32)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_trees(got_module, want_tree, atol, what):
    got = export_jax_params(got_module)
    want = dict(_flat(jax.device_get(want_tree)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=f"{what} {'/'.join(path)}")


@pytest.mark.parametrize("loss_type,loss_weight", [
    ("l1", None), ("l2", None), ("l1", {"type": "min_snr", "gamma": 5.0})])
def test_p_losses_matches_jax(loss_type, loss_weight):
    opt = _opt(ema=False, loss_type=loss_type, loss_weight=loss_weight)
    unet = randomize(DDPMModel(opt, device="cpu").unet, 3)
    jvars = jax_variables(JUNet(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4,
                                channel_mults=(1, 2), attn_res=(8,), res_blocks=1,
                                image_size=16), unet, *UNET_EX)
    jdiff = j_diffusion_for_phase(opt, "train")
    diff = diffusion_for_phase(opt, "train")
    assert (diff.loss_type, diff.loss_weight) == (jdiff.loss_type, jdiff.loss_weight)
    junet = JUNet(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4,
                  channel_mults=(1, 2), attn_res=(8,), res_blocks=1, image_size=16)
    batch = _batch(0, b=3)
    key = jax.random.PRNGKey(11)
    k_diff, _ = jax.random.split(key)
    want = float(jax.jit(lambda v, k, hr, sr: jdiff.p_losses(
        lambda x, t: junet.apply(v, x, t, train=True), k, hr, sr))(
            jvars, k_diff, batch["HR"], batch["SR"]))
    gamma, noise = _draws(jdiff, key, batch["HR"].shape)
    with torch.no_grad():
        got = float(diff.p_losses(unet, torch.tensor(batch["HR"]), torch.tensor(batch["SR"]),
                                  gamma=gamma, noise=noise))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_diffusion_for_phase_rejects_unknown_loss_weight():
    with pytest.raises(ValueError, match="loss_weight"):
        diffusion_for_phase(_opt(loss_weight={"type": "p2"}), "train")


def test_p_losses_draws_from_the_generator():
    opt = _opt(ema=False)
    ddpm = DDPMModel(opt, device="cpu")
    b = {k: torch.tensor(v) for k, v in _batch(1).items()}
    with torch.no_grad():
        losses = [float(ddpm.train_diffusion.p_losses(ddpm.unet, b["HR"], b["SR"],
                                                       generator=torch.Generator().manual_seed(s)))
                  for s in (5, 5, 6)]
    assert losses[0] == losses[1] != losses[2]


@pytest.fixture(scope="module")
def three_steps():
    """Three train steps of the port and of the JAX package from the same
    weights and draws, with the JAX gradients of the first step."""
    opt = _opt(sched={"type": "cosine", "decay_steps": 2, "alpha": 0.1})
    ddpm = DDPMModel(opt, seed=4, device="cpu")
    jm = _jax_ddpm(opt, ddpm.unet)
    batches = [_batch(10 + k) for k in range(3)]
    keys = [jax.random.PRNGKey(100 + k) for k in range(3)]

    k_diff, k_drop = jax.random.split(keys[0])

    def loss_fn(p):
        return jm.train_diffusion.p_losses(
            lambda x, t: jm.unet.apply({"params": p}, x, t, train=True,
                                       rngs={"dropout": k_drop}),
            k_diff, batches[0]["HR"], batches[0]["SR"])

    jloss0, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jax.device_get(jm.state.params))
    gamma, noise = _draws(jm.train_diffusion, keys[0], batches[0]["HR"].shape)
    loss0 = ddpm.compute_grads(batches[0], gamma=gamma, noise=noise)
    grads = state_dict_to_flax({k: p.grad.numpy() for k, p in ddpm.unet.named_parameters()})
    ddpm.apply_gradients()
    jlosses = [float(jm.train_step(batches[0], keys[0]))]
    losses = [float(loss0)]
    for batch, key in zip(batches[1:], keys[1:]):
        gamma, noise = _draws(jm.train_diffusion, key, batch["HR"].shape)
        losses.append(float(ddpm.train_step(batch, gamma=gamma, noise=noise)))
        jlosses.append(float(jm.train_step(batch, key)))
    return dict(ddpm=ddpm, jm=jm, grads=grads["params"], jgrads=jgrads, jloss0=float(jloss0),
                losses=losses, jlosses=jlosses)


def test_train_step_gradients_match_jax(three_steps):
    r = three_steps
    np.testing.assert_allclose(r["losses"][0], r["jloss0"], rtol=1e-5)
    want = dict(_flat(jax.device_get(r["jgrads"])))
    got = dict(_flat(r["grads"]))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg="/".join(path))


def test_three_steps_match_jax(three_steps):
    r = three_steps
    np.testing.assert_allclose(r["losses"], r["jlosses"], rtol=1e-5)
    ddpm, jm = r["ddpm"], r["jm"]
    assert ddpm.step == 3 and int(jm.state.step) == 3
    _assert_trees(ddpm.unet, jm.state.params, 0.05 * LR, "params")
    _assert_trees(ddpm.ema.module, jm.state.ema_params, 0.05 * LR, "ema")
    # eval samples the EMA, as the JAX package's eval_params
    assert ddpm.eval_unet is ddpm.ema.module
    _assert_trees(ddpm.eval_unet, jm.eval_params, 0.05 * LR, "eval")
    # the lr of the fourth update, as optax's count makes it
    assert ddpm.optimizer.param_groups[0]["lr"] == pytest.approx(LR * 0.1, rel=1e-12)


def test_ema_is_the_decayed_average():
    """ema = 0.9 ema + 0.1 params after every step, from step 0, starting
    at the initial weights; before the first step the model holds no
    optimizer and no EMA copy, and eval samples the live weights."""
    ddpm = DDPMModel(_opt(), device="cpu")
    prev = {k: v.clone() for k, v in ddpm.unet.state_dict().items()}
    assert ddpm._optimizer is None and ddpm._ema is None and ddpm.eval_unet is ddpm.unet
    ddpm.train_step(_batch(2), generator=torch.Generator().manual_seed(0))
    assert ddpm.eval_unet is ddpm.ema.module
    params = ddpm.unet.state_dict()
    for k, v in ddpm.ema.state_dict().items():
        torch.testing.assert_close(v, prev[k] * 0.9 + params[k] * 0.1, rtol=1e-6, atol=1e-7)
    assert not ddpm.unet.training


def test_dropout_mask_comes_from_the_generator():
    ddpm = DDPMModel(_opt(dropout=0.5, ema=False), device="cpu")
    b = _batch(3)
    gamma, noise = np.full(2, 0.5, np.float32), np.zeros((2, 16, 16, 3), np.float32)
    losses = []
    for seed in (1, 1, 2):
        ddpm.unet.load_state_dict(DDPMModel(_opt(dropout=0.5, ema=False), device="cpu")
                                  .unet.state_dict())
        losses.append(float(ddpm.compute_grads(b, torch.Generator().manual_seed(seed), gamma,
                                               noise)))
    assert losses[0] == losses[1] != losses[2]


def test_finetune_norm_trains_nothing():
    ddpm = DDPMModel(_opt(finetune=True), device="cpu")
    before = {k: v.clone() for k, v in ddpm.unet.state_dict().items()}
    ddpm.train_step(_batch(4), generator=torch.Generator().manual_seed(0))
    for k, v in ddpm.unet.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert ddpm.step == 1


@pytest.mark.filterwarnings("ignore:Detected call of `lr_scheduler.step()`")
@pytest.mark.parametrize("sched,ox", [
    ({"type": "cosine", "decay_steps": 16000, "alpha": 0.1},
     optax.cosine_decay_schedule(LR, 16000, alpha=0.1)),
    ({"type": "cosine", "decay_steps": 40, "alpha": 0.0},
     optax.cosine_decay_schedule(LR, 40, alpha=0.0)),
    ({"type": "step", "milestones": [3, 7, 7], "gamma": 0.1},
     optax.piecewise_constant_schedule(LR, {3: 0.1, 7: 0.1})),
])
def test_lr_schedule_counts_as_optax(sched, ox):
    """The k-th update (from 0) runs at optax's schedule(k), milestones
    included: read from the optimizer after k scheduler steps."""
    n = 17000 if sched.get("decay_steps", 0) > 1000 else 50
    ks = np.arange(n)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(jax.vmap(ox))(ks))
    assert want.dtype == np.float64
    f = lr_factor(sched)
    np.testing.assert_allclose([LR * f(int(k)) for k in ks], want, rtol=1e-7)
    ddpm = DDPMModel(_opt(ema=False, sched=sched), device="cpu")
    seen = []
    for _ in range(12):
        seen.append(ddpm.optimizer.param_groups[0]["lr"])
        ddpm.scheduler.step()
    np.testing.assert_allclose(seen, want[:12], rtol=1e-7)


def test_orthogonal_init_follows_the_jax_rules():
    unet = DDPMModel(_opt(ema=False), seed=3, device="cpu").unet
    flat = export_jax_params(unet)
    # the JAX rules on the same tree (each leaf shrunk to size 1, which
    # keeps its name and ndim): which leaves become orthogonal, ones, zeros
    tiny = {p: np.full((1,) * w.ndim, 0.5, np.float32) for p, w in flat.items()}
    jtree = j_init_weights(unflatten(tiny), jax.random.PRNGKey(0), init_type="orthogonal")
    jflat = dict(_flat(jax.device_get(jtree)))
    assert jflat.keys() == flat.keys()
    n_orth = 0
    for path, w in flat.items():
        rule = ("kernel" if path[-1] == "kernel" and w.ndim >= 2 else
                "scale" if path[-1] == "scale" else "zero")
        if rule == "kernel":
            assert abs(float(jflat[path].ravel()[0])) == 1.0, path  # a 1x1 orthogonal
            n_orth += 1
            m = w.transpose(3, 2, 0, 1).reshape(w.shape[-1], -1) if w.ndim == 4 else w.T
            gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
            np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5,
                                       err_msg="/".join(path))
        elif rule == "scale":
            assert (w == 1).all() and (jflat[path] == 1).all(), path
        else:
            assert (w == 0).all() and (jflat[path] == 0).all(), path
    assert n_orth > 10


@pytest.mark.parametrize("init_type", ["normal", "kaiming"])
def test_other_init_types(init_type):
    unet = DDPMModel(_opt(ema=False), device="cpu").unet
    init_weights(unet, torch.Generator().manual_seed(0), init_type=init_type, std=0.02)
    w = unet.downs[1].res_block.block1.block[3].weight
    want = 0.02 if init_type == "normal" else np.sqrt(2.0 / w[0].numel())
    assert abs(float(w.detach().std()) / want - 1) < 0.2
    assert float(unet.downs[1].res_block.block1.block[3].bias.abs().max()) == 0.0


def test_export_jax_params_round_trip():
    src = randomize(DDPMModel(_opt(ema=False), device="cpu").unet, 6)
    flat = export_jax_params(src)
    want = dict(_flat(state_dict_to_flax({k: v.numpy() for k, v in
                                          src.state_dict().items()})["params"]))
    assert flat.keys() == want.keys()
    for p, v in want.items():
        np.testing.assert_array_equal(flat[p], v, err_msg="/".join(p))
    dst = load_jax_params(DDPMModel(_opt(ema=False), seed=9, device="cpu").unet, unflatten(flat))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_checkpoint_round_trip(tmp_path):
    ddpm = DDPMModel(_opt(sched={"type": "step", "milestones": [1], "gamma": 0.5}),
                     device="cpu")
    for k in range(2):
        ddpm.train_step(_batch(20 + k), generator=torch.Generator().manual_seed(k))
    path = ddpm.save_checkpoint(str(tmp_path), epoch=3, iter_step=2)
    assert path.endswith("I2_E3")
    ddpm.save_checkpoint(str(tmp_path), epoch=3, iter_step=2)  # overwrites
    opt = _opt(sched={"type": "step", "milestones": [1], "gamma": 0.5})
    opt["path"]["resume_state"] = path
    back = DDPMModel(opt, seed=7, device="cpu")
    assert (back.begin_step, back.begin_epoch, back.step) == (2, 3, 2)
    for a, b in ((ddpm.unet, back.unet), (ddpm.ema.module, back.ema.module)):
        for k, v in a.state_dict().items():
            assert torch.equal(b.state_dict()[k], v), k
    sa, sb = ddpm.optimizer.state_dict(), back.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for name, v in st.items():
            assert torch.equal(sb["state"][i][name], v), (i, name)
    assert back.scheduler.state_dict() == ddpm.scheduler.state_dict()
    # both continue alike
    for m in (ddpm, back):
        m.train_step(_batch(30), generator=torch.Generator().manual_seed(9))
    for k, v in ddpm.unet.state_dict().items():
        assert torch.equal(back.unet.state_dict()[k], v), k


def test_npz_export_crosses_both_ways(tmp_path):
    """A port-trained model's export loads into the JAX DDPMModel, whose
    eval forward then equals the port's on the same f16 weights; the JAX
    package's export of it loads back into the port unchanged."""
    opt = _opt()
    ddpm = DDPMModel(opt, device="cpu")
    ddpm.train_step(_batch(5), generator=torch.Generator().manual_seed(0))
    path = ddpm.export_params_npz(str(tmp_path / "port.npz"))
    jopt = copy.deepcopy(opt)
    jopt["path"]["resume_state"] = path
    jm = _jax_ddpm(jopt, DDPMModel(opt, seed=3, device="cpu").unet)
    popt = copy.deepcopy(opt)
    popt["path"]["resume_state"] = path
    back = DDPMModel(popt, seed=3, device="cpu")
    rng = np.random.RandomState(7)
    x, t = rng.rand(2, 16, 16, 6).astype(np.float32), np.array([[0.3], [0.9]], np.float32)
    want = np.asarray(jax.jit(functools.partial(jm.unet.apply, train=False))(
        {"params": jm.eval_params}, x, t))
    with torch.no_grad():
        got = back.eval_unet(torch.tensor(x), torch.tensor(t)).numpy()
        own = ddpm.eval_unet(torch.tensor(x), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(own, want, atol=5e-3)   # f32 weights vs their f16 rounding
    jpath = jm.export_params_npz(str(tmp_path / "jax.npz"))
    popt["path"]["resume_state"] = jpath
    again = DDPMModel(popt, seed=5, device="cpu")
    for k, v in back.unet.state_dict().items():
        assert torch.equal(again.unet.state_dict()[k], v), k
        assert torch.equal(again.ema.state_dict()[k], v), k


def test_slice_train_step_matches_jax():
    """One step of the whole slice from HR crops: on-device degradation,
    frozen GAE encode of HR and SR, the G groups folded into one UNet
    batch, Adam and EMA; the port against the JAX pipeline."""
    opt = _opt()
    opt["gae"] = {"latent_shift": -0.5, "latent_scale": 1.5}
    gae_kw = dict(n_subs=8, n_ovls=2, n_colors=31, n_feats=16)
    gae_cfg = dict(gae_kw, G=5)
    gae = randomize(GAE(**gae_kw), 1)
    gvars = jax_variables(JGAE(**gae_kw), gae, np.zeros((1, 16, 16, 31), np.float32))
    ddpm = DDPMModel(opt, seed=2, device="cpu")
    jm = _jax_ddpm(opt, ddpm.unet)
    jpipe = JPipeline(opt, gvars, gae_cfg, ddpm=jm)
    pipe = DMGASRPipeline(opt, gae.state_dict(), gae_cfg, ddpm=ddpm, device="cpu")
    hr = np.random.RandomState(8).rand(2, 16, 16, 31).astype(np.float16)

    down = make_imresize_jax((16, 16), output_shape=(8, 8))
    up = make_imresize_jax((8, 8), output_shape=(16, 16))
    sr_want = np.clip(np.asarray(up(np.clip(down(hr.astype(np.float32)), 0, 1))), 0, 1)
    sr_got = pipe._degrade_fn((16, 16), 2)(torch.tensor(hr).float()).numpy()
    np.testing.assert_allclose(sr_got, sr_want, atol=1e-6)

    key = jax.random.PRNGKey(3)
    want = float(jpipe.train_step_from_hr(hr, scale=2, key=key))
    gamma, noise = _draws(jm.train_diffusion, key, (10, 16, 16, 3))
    with mock.patch.object(ddpm, "train_step", functools.partial(ddpm.train_step, gamma=gamma,
                                                                 noise=noise)):
        got = float(pipe.train_step_from_hr(hr, scale=2))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_trees(ddpm.unet, jm.state.params, 0.05 * LR, "params")
    _assert_trees(ddpm.ema.module, jm.state.ema_params, 0.05 * LR, "ema")


def test_per_group_steps():
    """per_group=True: G sequential optimizer steps, the mean loss."""
    opt = _opt(ema=False)
    gae_cfg = dict(n_subs=8, n_ovls=2, n_colors=31, n_feats=16, G=5)
    pipe = DMGASRPipeline(opt, None, gae_cfg, ddpm=DDPMModel(opt, device="cpu"), device="cpu")
    hr = np.random.RandomState(9).rand(1, 16, 16, 31).astype(np.float32)
    loss = pipe.train_step_from_hr(hr, scale=2, per_group=True,
                                   generator=torch.Generator().manual_seed(0))
    assert pipe.ddpm.step == 5 and torch.isfinite(loss)
