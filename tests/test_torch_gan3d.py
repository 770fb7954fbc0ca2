"""The port's 3-D attention GAN (``models/baselines/gan3d.py``),
``GAN3DTrainer`` and ``cli.gan_train`` against the JAX package and the
reference golden.

The generator and the discriminator load the golden's reference
state_dicts strictly and reproduce its outputs (D in eval mode on its
randomised running statistics), at the JAX tests' atol 2e-5, rtol 1e-4;
their parameter counts are the golden's. On JAX param trees (seeded
weights through the JAX package's converter, checked against the JAX
init's paths and shapes) moved in by ``load_jax_params``: G, D in eval
mode, and D after a train-mode pass (its output and its running
statistics, flax's rule) against the JAX forward, at the same
tolerance; ``export_jax_params`` gives every leaf back. The losses match
the JAX functions at 1e-6. One trainer step (D, then G against the
updated D) matches the JAX trainer's ``_d_step`` and ``_g_step`` from the
same weights (its nets' ``init`` handed them), both sides in f64: both
losses, every parameter of both nets after Adam and D's running
statistics, atol 1e-7.
"""

import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.io.convert_torch import state_dict_to_flax
from hsi_dmgasr_tpu.models.baselines import gan3d as jg
from hsi_dmgasr_tpu.train import gan_trainer as jtrainer
from hsi_dmgasr_tpu_torch.cli import gan_train
from hsi_dmgasr_tpu_torch.io.convert_torch import (
    export_jax_params,
    load_jax_params,
    load_state_dict,
)
from hsi_dmgasr_tpu_torch.models.baselines import gan3d as pg
from hsi_dmgasr_tpu_torch.train.gan_trainer import GAN3DTrainer
from torch_port_weights import randomize

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "gan3d_forward_golden.npz")
ATOL, RTOL = 2e-5, 1e-4
# the f64 step: every parameter and running statistic (exported in f32,
# which rounds values of order 0.1 by about 1e-8), and both losses
TOL_STEP = 1e-7


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _golden(prefix):
    g = np.load(GOLDEN)
    return {k.split("::", 1)[1]: g[k] for k in g.files if k.startswith(prefix)}, g


def _variables(module, group, seed):
    """Seeded weights (D's running statistics too) as JAX variables."""
    randomize(module, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return state_dict_to_flax({k: v.numpy().copy() for k, v in module.state_dict().items()},
                              model=group)


def _nets(n_bands=8):
    gv = _variables(pg.Generator(n_bands), "gan3d_g", seed=1)
    dv = _variables(pg.Discriminator(), "gan3d_d", seed=2)
    return gv, dv


def test_generator_golden():
    sd, g = _golden("gsd::")
    m = pg.Generator(31)
    load_state_dict(m, sd)
    with torch.no_grad():
        y = m(torch.from_numpy(np.moveaxis(g["g_x"][:, 0], 1, -1))).numpy()
    np.testing.assert_allclose(y, np.moveaxis(g["g_y"][:, 0], 1, -1), atol=ATOL, rtol=RTOL)


def test_discriminator_golden():
    sd, g = _golden("dsd::")
    m = pg.Discriminator().eval()
    load_state_dict(m, sd)
    with torch.no_grad():
        y = m(torch.from_numpy(np.moveaxis(g["d_x"][:, 0], 1, -1))).numpy()
    np.testing.assert_allclose(y, g["d_y"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("net", ["g", "d"])
def test_param_count(net):
    m = pg.Generator(31) if net == "g" else pg.Discriminator()
    assert sum(p.numel() for p in m.parameters()) == int(np.load(GOLDEN)[f"{net}_params"])


def test_generator_against_jax():
    gv, _ = _nets()
    x = _rand(2, 4, 4, 8, seed=3)
    shapes = jax.eval_shape(jg.Generator(n_bands=8).init, jax.random.PRNGKey(0), x)
    assert jax.tree.map(np.shape, gv) == jax.tree.map(lambda a: a.shape, shapes)
    want = np.asarray(jg.Generator(n_bands=8).apply(gv, x))
    m = load_jax_params(pg.Generator(8), gv, model="gan3d_g")
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    back, flat = export_jax_params(m, model="gan3d_g"), _flat(gv["params"])
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[p], a) for p, a in flat.items())


def test_discriminator_against_jax_eval_and_train():
    _, dv = _nets()
    x = _rand(2, 16, 16, 8, seed=4)
    jd = jg.Discriminator()
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), x)
    assert jax.tree.map(np.shape, dv) == jax.tree.map(lambda a: a.shape, shapes)
    m = load_jax_params(pg.Discriminator(), dv, model="gan3d_d")
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jd.apply(dv, x, train=False)), atol=ATOL,
                               rtol=RTOL)
    want, upd = jd.apply(dv, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = m.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    stats = export_jax_params(m, "batch_stats", model="gan3d_d")
    for path, arr in _flat(upd["batch_stats"]).items():
        np.testing.assert_allclose(stats[path], arr, atol=ATOL, rtol=RTOL, err_msg=str(path))
    assert export_jax_params(m, model="gan3d_d").keys() == _flat(dv["params"]).keys()


def test_losses_against_jax():
    x, y = _rand(2, 6, 5, 8, seed=5), _rand(2, 6, 5, 8, seed=6)
    d_real, d_fake = _rand(4, 1, seed=7), _rand(4, 1, seed=8)
    t = torch.from_numpy
    for got, want in ((pg.spe_loss_gan(t(x), t(y)), jg.spe_loss_gan(x, y)),
                      (pg.ragan_d_loss(t(d_real), t(d_fake)), jg.ragan_d_loss(d_real, d_fake)),
                      (pg.ragan_g_loss(t(d_real), t(d_fake)), jg.ragan_g_loss(d_real, d_fake))):
        np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)


def test_trainer_step_against_jax():
    """One D step then one G step against the updated D, both sides in f64
    (f32 gradients of D's BatchNorm scales cancel to their rounding floor,
    and Adam's first update, lr g / (|g| + 1e-8), would carry that
    rounding into the parameters)."""
    gv, dv = jax.tree.map(lambda a: np.asarray(a, np.float64), _nets())
    lr_cube, hr = _rand(2, 4, 4, 8, seed=9).astype(np.float64), \
        _rand(2, 16, 16, 8, seed=10).astype(np.float64)
    with jax.enable_x64(True):
        with mock.patch.object(jg.Generator, "init", lambda self, *a, **k: gv), \
                mock.patch.object(jg.Discriminator, "init", lambda self, *a, **k: dv):
            jtr = jtrainer.GAN3DTrainer(n_bands=8, example_hw=4)
        jtr.d_state, want_d = jtr._d_step(jtr.g_state, jtr.d_state, lr_cube, hr)
        jtr.g_state, want_g = jtr._g_step(jtr.g_state, jtr.d_state, lr_cube, hr)
        want = {"gan3d_g": _flat(jtr.g_state.params), "gan3d_d": _flat(jtr.d_state.params)}
        want_stats = _flat(jtr.d_state.batch_stats)
        assert want_stats[("b2", "mean")].dtype == np.float64

    tr = GAN3DTrainer(n_bands=8, device="cpu")
    load_jax_params(tr.G, gv, model="gan3d_g").double()
    load_jax_params(tr.D, dv, model="gan3d_d").double()
    g_loss, d_loss = tr.train_step(lr_cube, hr)
    np.testing.assert_allclose(float(d_loss), float(want_d), atol=TOL_STEP, rtol=TOL_STEP)
    np.testing.assert_allclose(float(g_loss), float(want_g), atol=TOL_STEP, rtol=TOL_STEP)
    got = {"gan3d_g": export_jax_params(tr.G, model="gan3d_g"),
           "gan3d_d": export_jax_params(tr.D, model="gan3d_d")}
    for group, leaves in want.items():
        for path, arr in leaves.items():
            np.testing.assert_allclose(got[group][path], arr, atol=TOL_STEP, rtol=0,
                                       err_msg=f"{group} {path}")
    stats = export_jax_params(tr.D, "batch_stats", model="gan3d_d")
    for path, arr in want_stats.items():
        np.testing.assert_allclose(stats[path], arr, atol=TOL_STEP, rtol=0, err_msg=str(path))


def test_gan_train_cli(tmp_path):
    """cli.gan_train in-process on a tiny stacked-scene .npy (N, C, H, W),
    uint16 range, then its checkpoint into a fresh trainer."""
    data = tmp_path / "scenes.npy"
    np.save(data, (np.random.RandomState(0).rand(1, 8, 56, 56) * (2 ** 16 - 1)).astype(np.float32))
    out = str(tmp_path / "gan")
    tr = gan_train.main(["--data", str(data), "--n_bands", "8", "--fis", "16", "--batch_size",
                         "2", "--epochs", "1", "--max_steps", "2", "--out", out,
                         "--device", "cpu"])
    fresh = GAN3DTrainer(n_bands=8, seed=1, device="cpu")
    fresh.load(out)
    for a, b in ((tr.G, fresh.G), (tr.D, fresh.D)):
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
