"""The port's ``BaselineTrainer`` and ``cli.baselines`` against the JAX
package.

One step from the same weights and batch: every parameter after Adam
within atol 1e-5 (f32 sums in another order, then one Adam update of lr
1e-4), the loss within rtol 1e-4. For ``sspsr`` and ``mcnet`` the other
side is the JAX package's own ``BaselineTrainer`` (its model's ``init``
handed the weights, as an eager init costs tens of seconds on the CPU),
with and without ``grad_clip``. For ``gelin``, ``edsr`` at scale 2 and ``gdrrn``,
which the JAX trainer cannot step (ROADMAP.md §3), it is a step built
from the JAX model, the JAX trainer's ``default_loss`` and
``optax.adam``. Then the trainer's checkpoint, and the CLI's train and
test in-process on tiny seeded scenes with ``--device cpu``, with its two
repairs: gdrrn fed the bicubic-upsampled cube, edsr at scale 4 refused.
"""

import os
from unittest import mock

import jax
import numpy as np
import optax
import pytest
import torch

from hsi_dmgasr_tpu.io.convert_torch import state_dict_to_flax
from hsi_dmgasr_tpu.models import baselines as jb
from hsi_dmgasr_tpu.train import baseline_trainer as jtrainer
from hsi_dmgasr_tpu_torch.cli import baselines as cli
from hsi_dmgasr_tpu_torch.io.convert_torch import export_jax_params
from hsi_dmgasr_tpu_torch.train.baseline_trainer import BaselineTrainer
from torch_port_weights import randomize

TOL = 1e-5
# the loss relative: gdrrn's myloss_spe sums 6e4 squared errors (about
# 2.8e3 on these weights), and an f32 sum of that length in another order
# moves by about 1e-5 of itself
TOL_LOSS = 1e-4
# name -> (scale, width overrides, JAX model class, rule group)
CASES = {
    "sspsr": (4, {"n_feats": 16, "n_blocks": 1}, jb.SSPSR, None),
    "mcnet": (4, {"n_feats": 8}, jb.MCNet, "mcnet"),
    "gelin": (4, {"n_feats": 16, "blocks": 1}, jb.GELIN, None),
    "edsr": (2, {"n_feats": 16, "n_resblocks": 2}, jb.EDSR, "edsr"),
    "gdrrn": (4, {"num_chnl": 16, "group": 4, "recursions": 3}, jb.GDRNN, None),
}


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _batch(name, scale):
    """(input, hr, lms) of 2 items at LR 8^2 x 31: gdrrn refines an
    HR-size cube, gelin adds an HR-size lms, the others take lms = LR."""
    lr, hr = _rand(2, 8, 8, 31, seed=1), _rand(2, 8 * scale, 8 * scale, 31, seed=2)
    up = _rand(2, 8 * scale, 8 * scale, 31, seed=3)
    if name == "gdrrn":
        return up, hr, None
    return lr, hr, up if name == "gelin" else None


def _port(name, scale, overrides, group, grad_clip=None):
    """A port trainer on the CPU with seeded weights, and those weights as
    a JAX params tree (through the JAX package's converter)."""
    tr = BaselineTrainer(name, 31, scale, grad_clip=grad_clip, device="cpu", **overrides)
    randomize(tr.model, seed=5)
    sd = {k: v.detach().numpy().copy() for k, v in tr.model.state_dict().items()}
    return tr, state_dict_to_flax(sd, model=group)["params"]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _check(tr, group, loss, want_loss, want_params):
    np.testing.assert_allclose(float(loss), float(want_loss), atol=TOL, rtol=TOL_LOSS)
    got = export_jax_params(tr.model, model=group)
    want = _flat(want_params)
    assert got.keys() == want.keys()
    for path, arr in want.items():
        np.testing.assert_allclose(got[path], arr, atol=TOL, rtol=0, err_msg="/".join(path))


@pytest.mark.parametrize("name,grad_clip", [("sspsr", None), ("mcnet", None),
                                            ("sspsr", 1e-6), ("mcnet", 1e-6)])
def test_step_against_the_jax_trainer(name, grad_clip):
    """grad_clip 1e-6 scales the gradients to where Adam's eps moves the
    update, so a clip that did nothing would show."""
    scale, overrides, cls, group = CASES[name]
    tr, params = _port(name, scale, overrides, group, grad_clip)
    x, hr, lms = _batch(name, scale)
    with mock.patch.object(cls, "init", lambda self, *a, **k: {"params": params}):
        jtr = jtrainer.BaselineTrainer(name, 31, scale, grad_clip=grad_clip, **overrides)
    want_loss = jtr.train_step(x, hr, lms=lms)
    _check(tr, group, tr.train_step(x, hr, lms=lms), want_loss, jtr.state.params)


@pytest.mark.parametrize("name", ["gelin", "edsr", "gdrrn"])
def test_step_against_a_jax_step(name):
    """The JAX trainer cannot step these models (ROADMAP.md §3): the other
    side is the JAX model's forward, the JAX trainer's loss and optax.adam."""
    scale, overrides, _, group = CASES[name]
    tr, params = _port(name, scale, overrides, group)
    x, hr, lms = _batch(name, scale)
    jm = jtrainer.build_baseline(name, 31, scale, **overrides)
    loss_fn = jtrainer.default_loss(name)
    args = (x,) if lms is None else (x, lms)
    tx = optax.adam(1e-4)

    def loss(p):
        return loss_fn(jm.apply({"params": p}, *args), hr, hr.shape[0])

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    _check(tr, group, tr.train_step(x, hr, lms=lms), want_loss,
           optax.apply_updates(params, updates))


def test_save_load_round_trip(tmp_path):
    tr = BaselineTrainer("mcnet", 31, 4, device="cpu", n_feats=8)
    x, hr, _ = _batch("mcnet", 4)
    tr.train_step(x, hr)
    tr.save(str(tmp_path / "ck"))
    fresh = BaselineTrainer("mcnet", 31, 4, seed=3, device="cpu", n_feats=8)
    fresh.load(str(tmp_path / "ck"))
    assert all(torch.equal(v, fresh.model.state_dict()[k])
               for k, v in tr.model.state_dict().items())
    assert torch.equal(tr.predict(x), fresh.predict(x))
    with pytest.raises(ValueError, match="holds"):
        BaselineTrainer("mcnet", 31, 4, device="cpu", n_feats=4).load(str(tmp_path / "ck"))


def test_build_baseline_defaults_match_jax():
    """The JAX package's per-model defaults, EDSR's x2 pin included."""
    for name in CASES:
        want = jtrainer.build_baseline(name, 102, 4)
        got = BaselineTrainer(name, 102, 4, device="cpu").model
        if name == "sspsr":
            assert (got.groups.G, got.sca, got.skip_conv.out_channels) == (17, 2, want.n_feats)
        if name == "edsr":
            assert want.scale == 2 and len(got.tail[0]) == 2  # one conv + shuffle stage
        if name == "mcnet":
            assert got.head.out_channels == want.n_feats == 32
        if name == "gdrrn":
            assert got.conv1.groups == want.group == 1
        if name == "gelin":
            assert (got.n_feats, len(got.branch.body)) == (want.n_feats, want.blocks)


# ---------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """2 training scenes of 72^2 x 31 and 1 test scene of 64^2 x 31, .npy."""
    root = tmp_path_factory.mktemp("baseline_scenes")
    rng = np.random.RandomState(0)
    for split, n, hw in (("train", 2, 72), ("test", 1, 64)):
        os.makedirs(root / split)
        for i in range(n):
            np.save(root / split / f"s{i}.npy", rng.rand(hw, hw, 31).astype(np.float32))
    return root


def _train_test(scenes, tmp_path, name, scale, *extra):
    out = str(tmp_path / name)
    common = ["--model", name, "--n_colors", "31", "--scale", str(scale), "--device", "cpu",
              *extra]
    tr = cli.main(["train", *common, "--data", str(scenes / "train"), "--batch_size", "2",
                   "--epochs", "1", "--max_steps", "2", "--out", out])
    qa = cli.main(["test", *common, "--data", str(scenes / "test"), "--ckpt", out,
                   "--gt_size", "32"])
    assert tr.step == 2 and qa and all(np.isfinite(v) for v in qa.values())
    return tr


def test_cli_train_test_sspsr(scenes, tmp_path):
    _train_test(scenes, tmp_path, "sspsr", 2, "--n_feats", "8")


def test_cli_gdrrn_is_fed_the_upsampled_cube(scenes, tmp_path):
    """The JAX CLI feeds gdrrn the LR cube, whose output (LR size) fails
    the HR loss; the port feeds it ``SR``, the cube it is built for."""
    seen = []
    real = BaselineTrainer.compute_grads

    def spy(self, x, hr, lms=None):
        seen.append((np.shape(x), np.shape(hr), lms))
        return real(self, x, hr, lms)

    with mock.patch.object(BaselineTrainer, "compute_grads", spy):
        _train_test(scenes, tmp_path, "gdrrn", 2)
    assert seen == [((2, 64, 64, 31), (2, 64, 64, 31), None)] * 2


def test_cli_edsr_x2_trains_and_other_scales_raise(scenes, tmp_path):
    _train_test(scenes, tmp_path, "edsr", 2, "--n_feats", "8")
    with pytest.raises(ValueError, match="x2 only"):
        cli.main(["train", "--model", "edsr", "--data", str(scenes / "train"), "--scale", "4",
                  "--device", "cpu"])
