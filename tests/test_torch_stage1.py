"""The port's stage 1 on the CPU against the JAX package: GAETrainer's
step (HLoss, masked L1), its learning, checkpoints and reconstruct; the
whole-module GAE pickle reader; the ae and gae_test CLIs; stage 2's GAE
loader on what stage 1 writes.

Both trainers start from the same params: seeded weights handed to the
JAX trainer by the JAX package's converter (its eager init alone takes
14 s here), and carried from there into the port by load_jax_params.
The JAX trainer's Adam is
swapped for a transformation that keeps the gradients in its opt_state,
so the test reads exactly the gradients of the JAX step. Mask and band
draws are the JAX step's own, recomputed from its key and injected into
the port. Tolerances: the loss rtol 1e-5 (tests/test_losses.py's);
gradients rtol 1e-4 with atol 1e-4 of each leaf's largest |g| (f32 sums
in another order); a reconstruction from saved weights atol 1e-6 (the
JAX test's)."""

import copy
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hsi_dmgasr_tpu.io.convert_torch import load_torch_gae as j_load_torch_gae
from hsi_dmgasr_tpu.io.convert_torch import state_dict_to_flax
from hsi_dmgasr_tpu.models.gae import GAE as JGAE
from hsi_dmgasr_tpu.parallel.mesh import replicate
from hsi_dmgasr_tpu.train.stage1_gae import GAETrainer as JGAETrainer
from hsi_dmgasr_tpu.train.state import create_train_state
from hsi_dmgasr_tpu_torch.cli import ae, gae_test
from hsi_dmgasr_tpu_torch.io.convert_torch import load_jax_params, load_torch_gae, stub_class
from hsi_dmgasr_tpu_torch.models import gae as gae_mod
from hsi_dmgasr_tpu_torch.ops import blocks
from hsi_dmgasr_tpu_torch.train import stage2_driver
from hsi_dmgasr_tpu_torch.train.stage1_gae import GAETrainer
from torch_port_weights import jax_variables, randomize

GAE_KW = dict(n_subs=8, n_ovls=2, n_colors=31, n_feats=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's thread pool only spins against the other test
    workers of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- helpers


def _capture_grads():
    """An optax transformation that leaves the params as they are and keeps
    the last gradients as its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def jax_and_port(perceptual=None, **kw):
    """(JAX trainer that records its gradients, port trainer) on the same
    params: the JAX trainer's, carried into the port."""
    variables = jax_variables(JGAE(**GAE_KW), randomize(gae_mod.GAE(**GAE_KW), 11),
                              np.zeros((1, 16, 16, GAE_KW["n_colors"]), np.float32))
    jtr = JGAETrainer(**GAE_KW, variables=variables, perceptual_fn=perceptual and perceptual[0],
                      perceptual_weight=kw.get("perceptual_weight", 1e-3),
                      mask_p=kw.get("mask_p", 0.0), loss=kw.get("loss", "hloss"))
    cap = _capture_grads()
    jtr.tx = cap
    jtr.state = replicate(jtr.mesh, create_train_state(jtr.variables, cap))
    sd = load_jax_params(gae_mod.GAE(**GAE_KW), jtr.variables).state_dict()
    ptr = GAETrainer(**GAE_KW, state_dict=sd, perceptual_fn=perceptual and perceptual[1],
                     device="cpu", **kw)
    return jtr, ptr


def jax_grads(jtr):
    """The gradients of the JAX trainer's last step, in the port's layout."""
    grads = jax.tree.map(lambda g: np.array(g), jtr.state.opt_state)
    return load_jax_params(gae_mod.GAE(**GAE_KW), {"params": grads}).state_dict()


def assert_step_matches(jtr, ptr, hr, key, **inject):
    """One step of each from the same params: loss and every gradient."""
    want = float(jtr.train_step(hr, key=key))
    got = ptr.compute_grads(hr, **inject).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want_g = jax_grads(jtr)
    for name, p in ptr.gae.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


# reference class of each port module class (AE.py's __main__ classes and
# common.py's), as the shipped GAE_*.pth pickles name them
_REF_CLASSES = {
    gae_mod.GAE: ("__main__", "GAE"), gae_mod.GAEEncoder: ("__main__", "Encoder"),
    gae_mod.GAEDecoder: ("__main__", "Decoder"), blocks.BranchUnit: ("__main__", "BranchUnit"),
    blocks.SSPN: ("__main__", "SSPN"), blocks.SSB: ("__main__", "SSB"),
    blocks.ResBlock: ("common", "ResBlock"),
    blocks.ResAttentionBlock: ("common", "ResAttentionBlock"),
    blocks.CALayer: ("common", "CALayer"), blocks.Upsampler: ("common", "Upsampler"),
}


def write_reference_pickle(gae, path, monkeypatch):
    """Save ``gae`` as the reference saves a GAE (``torch.save(AE_model)``,
    AE.py:637): the same tensors in a module tree whose classes are named
    ``__main__.GAE``, ``common.ResBlock``, ..., with the reference's
    ``start_idx``/``end_idx`` and plain torch convs."""
    mod = copy.deepcopy(gae)
    for m in mod.modules():
        if type(m) in _REF_CLASSES:
            m.__class__ = stub_class(*_REF_CLASSES[type(m)])
        elif type(m) is blocks.Conv2d:
            m.__class__ = torch.nn.Conv2d
    idx = gae_mod.group_indices(gae.n_colors, GAE_KW["n_subs"], GAE_KW["n_ovls"])
    mod.start_idx = [int(r[0]) for r in idx]
    mod.end_idx = [int(r[-1]) + 1 for r in idx]
    for name in ("idx", "counts"):
        del mod._buffers[name]
        mod._non_persistent_buffers_set.discard(name)
    common = types.ModuleType("common")
    monkeypatch.setitem(sys.modules, "common", common)
    for module, name in set(_REF_CLASSES.values()):
        owner = sys.modules["__main__"] if module == "__main__" else common
        monkeypatch.setattr(owner, name, stub_class(module, name), raising=False)
    torch.save(mod, path)
    return path


def _hr(seed=0, shape=(2, 16, 16, 31)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


# ------------------------------------------------------------- trainer


def test_hloss_step_matches_jax():
    jtr, ptr = jax_and_port()
    assert_step_matches(jtr, ptr, _hr(1), jax.random.PRNGKey(3))


def test_masked_l1_step_matches_jax():
    """The AEddp recipe: the mask the JAX step draws from its key, injected."""
    jtr, ptr = jax_and_port(mask_p=0.6, loss="l1")
    hr, key = _hr(2), jax.random.PRNGKey(4)
    k_mask, _ = jax.random.split(key)
    mask = torch.from_numpy(np.array(jax.random.uniform(k_mask, hr.shape) > 0.6))
    assert_step_matches(jtr, ptr, hr, key, mask=mask)


def test_f16_input_is_widened_on_the_device():
    _, ptr = jax_and_port()
    hr16 = _hr(5).astype(np.float16)
    a = ptr.loss(hr16).item()
    b = ptr.loss(hr16.astype(np.float32)).item()
    assert a == b


def test_gae_trainer_learns_saves_and_reconstructs(tmp_path):
    """tests/test_losses.py's case: 30 steps at lr 1e-3 on a fixed batch;
    then save -> load_gae_variables -> a fresh GAE reconstructs the same."""
    tr = GAETrainer(**GAE_KW, lr=1e-3, device="cpu")
    hr = _hr(0)
    losses = [tr.train_step(hr).item() for _ in range(30)]
    assert losses[-1] < losses[0]
    path = tmp_path / "gae_ckpt"
    tr.save(str(path))
    tr.save(str(path))  # a second save to the same path replaces the first
    sd, cfg = GAETrainer.load_gae_variables(str(path))
    assert cfg == dict(GAE_KW, G=5)
    fresh = gae_mod.GAE(**GAE_KW)
    fresh.load_state_dict(sd)
    for k, v in tr.gae.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with torch.no_grad():
        want, _ = fresh(torch.from_numpy(hr))
    np.testing.assert_allclose(tr.reconstruct(hr).numpy(), want.numpy(), atol=1e-6)


def test_trainer_refuses_an_unknown_loss():
    with pytest.raises(ValueError, match="hloss"):
        GAETrainer(**GAE_KW, loss="l2", device="cpu")


# ------------------------------------------------------- checkpoints


def test_load_torch_gae_reads_a_whole_module_pickle(tmp_path, monkeypatch):
    src = GAETrainer(**GAE_KW, seed=3, device="cpu").gae
    path = write_reference_pickle(src, tmp_path / "GAE_4_test.pth", monkeypatch)
    monkeypatch.undo()  # the reader needs no class in sys.modules
    assert "common" not in sys.modules
    sd, cfg = load_torch_gae(str(path))
    jvars, jcfg = j_load_torch_gae(str(path))
    assert cfg == jcfg
    assert {k: cfg[k] for k in (*GAE_KW, "G")} == dict(GAE_KW, G=5)
    assert sd.keys() == src.state_dict().keys()
    for k, v in src.state_dict().items():
        assert torch.equal(sd[k], v), k
    want = jax.tree_util.tree_leaves_with_path(jvars["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        {k: v.numpy() for k, v in sd.items()})["params"]))
    assert len(want) == len(got)
    for p, v in want:
        np.testing.assert_array_equal(got[p], v)


def test_stage2_load_gae_takes_what_stage1_writes(tmp_path, monkeypatch):
    """A stage-1 directory and a whole-module pickle, their widths from the
    checkpoint; a section that disagrees is an error."""
    tr = GAETrainer(**GAE_KW, seed=4, device="cpu")
    ckpt_dir = tmp_path / "stage1"
    tr.save(str(ckpt_dir))
    pth = write_reference_pickle(tr.gae, tmp_path / "GAE.pth", monkeypatch)
    monkeypatch.undo()
    for ckpt, section in ((ckpt_dir, {}), (pth, {}), (ckpt_dir, GAE_KW), (pth, GAE_KW)):
        gae, cfg = stage2_driver.load_gae({"gae": dict(section, checkpoint=str(ckpt))})
        assert cfg == dict(GAE_KW, G=5)
        for k, v in tr.gae.state_dict().items():
            assert torch.equal(gae.state_dict()[k], v), (ckpt, k)
    for ckpt in (ckpt_dir, pth):
        with pytest.raises(ValueError, match="n_feats"):
            stage2_driver.load_gae({"gae": dict(GAE_KW, n_feats=16, checkpoint=str(ckpt))})


# -------------------------------------------------------------- CLIs


AE_ARGS = ["--epochs", "2", "--batch_size", "2", "--max_steps", "2", "--n_subs", "8",
           "--n_ovls", "2", "--n_colors", "31", "--n_feats", "8", "--scale", "2",
           "--device", "cpu"]


@pytest.mark.parametrize("datatype,extra", [("hsi_mat", []), ("hsi_mat", ["--device_resident"]),
                                            ("mat_pairs", [])])
def test_ae_cli_trains_and_saves(synth_data, tmp_path, datatype, extra):
    data = f"{synth_data}/mat_scenes" if datatype == "hsi_mat" else f"{synth_data}/pairs/train"
    out = str(tmp_path / "gae_ckpt")
    tr = ae.main(["--data", data, "--datatype", datatype, "--out", out, *AE_ARGS, *extra])
    assert tr.step == 2
    sd, cfg = GAETrainer.load_gae_variables(out)
    assert cfg == dict(GAE_KW, G=5)
    for k, v in tr.gae.state_dict().items():
        assert torch.equal(sd[k], v), k


@pytest.mark.parametrize("transfer_dtype", ["float16", "float32"])
def test_ae_cli_host_path_is_the_trainer_on_the_loader(synth_data, tmp_path, transfer_dtype):
    """The CLI's host loop is GAETrainer(seed) on the seeded loader's HR
    batches, rounded to --transfer_dtype: the same weights bit for bit."""
    from hsi_dmgasr_tpu_torch.data.loader import DataLoader
    from hsi_dmgasr_tpu_torch.data.mat_folder import TrainsetFromFolder

    data = f"{synth_data}/pairs/train"
    out = str(tmp_path / "gae_ckpt")
    got = ae.main(["--data", data, "--datatype", "mat_pairs", "--out", out,
                   "--transfer_dtype", transfer_dtype, *AE_ARGS])
    want = GAETrainer(**GAE_KW, device="cpu")
    loader = DataLoader(TrainsetFromFolder(data, scale=2), batch_size=2, shuffle=True, seed=0)
    for _ in range(2):  # two pairs: one step an epoch
        for batch in loader:
            want.train_step(batch["HR"].astype(transfer_dtype))
    assert got.step == want.step == 2
    for k, v in want.gae.state_dict().items():
        assert torch.equal(got.gae.state_dict()[k], v), k


def test_gae_test_cli_matches_jax(synth_data, tmp_path, monkeypatch, capsys):
    """Both CLIs on the same whole-module pickle and scenes."""
    from hsi_dmgasr_tpu.cli import gae_test as j_gae_test

    gae = GAETrainer(**GAE_KW, seed=5, device="cpu").gae
    pth = str(write_reference_pickle(gae, tmp_path / "GAE.pth", monkeypatch))
    monkeypatch.undo()
    args = ["--ckpt", pth, "--data", f"{synth_data}/npy_scenes", "--gt_size", "32",
            "--scale", "2"]
    want = j_gae_test.main(args)
    got = gae_test.main([*args, "--device", "cpu"])
    assert "cube 1:" in capsys.readouterr().out
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    # a stage-1 directory loads too
    ckpt = str(tmp_path / "stage1")
    GAETrainer(**GAE_KW, state_dict=gae.state_dict(), device="cpu").save(ckpt)
    again = gae_test.main([*args[:1], ckpt, *args[2:], "--device", "cpu"])
    for k in want:
        np.testing.assert_allclose(again[k], got[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [GAE_KW, dict(n_subs=16, n_ovls=4, n_colors=102, n_feats=64)])
def test_gae_forward_ops_count_every_conv(kw):
    """utils/roofline.py's GAE op list (the train_gae roofline's FLOPs)
    against torch's own FLOP counter on one forward."""
    from torch.utils.flop_counter import FlopCounterMode

    from hsi_dmgasr_tpu_torch.utils.roofline import gae_forward_ops

    gae = gae_mod.GAE(**kw)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        gae(torch.rand((2, 8, 8, kw["n_colors"])))
    assert counter.get_total_flops() == sum(op.flops for op in gae_forward_ops(2, 8, **kw))
