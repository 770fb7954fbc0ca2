"""The port's single-device memory modes against the JAX package:
``model.diffusion.latent_chunk`` (the reverse chain over batch chunks)
and ``model.unet.remat`` (the resblocks recomputed in the backward).

latent_chunk: the port's chunked chains, ancestral at ``t_start`` and
DDIM, from replayed draws, against the JAX package's
``sample_loop``/``ddim_sample_loop`` run on each chunk with that chunk's
draws (1e-5; DDIM 1e-4, see ``TOL_DDIM_JAX``), and against the port's
unchunked chain from the same draws (1e-5); the JAX package's rule for
when a chunk counts (its fall-back cases of
``tests/test_pipeline.py:test_latent_chunked_sampler``, and
``continous``); the draws from a generator, one derived generator per
chunk.

remat: both cases of ``tests/test_remat.py`` on the port, against the JAX
UNet on the same weights (through ``load_jax_params``): the same function
to 2e-6, the gradients to atol 1e-4 and rtol 1e-3; then the two traps of
a recompute, each compared with the same step without remat: dropout 0.2
drawn from the trainer's generator (the loss, every gradient and the
generator's state after the step) and BatchNorm's running statistics
(moved once).
"""

import copy
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.models.networks import define_G as j_define_G
from hsi_dmgasr_tpu.models.networks import diffusion_for_phase as j_diffusion
from hsi_dmgasr_tpu.models.unet import UNet as JUNet
from hsi_dmgasr_tpu_torch.diffusion import split_generator
from hsi_dmgasr_tpu_torch.io.convert_torch import load_jax_params
from hsi_dmgasr_tpu_torch.models import unet as unet_mod
from hsi_dmgasr_tpu_torch.models.unet import UNet
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
from torch_port_weights import jax_variables, randomize

TOL = 1e-5
# DDIM against the JAX package: test_torch_ddim.py's chain tolerance. Its
# first step divides the UNet's output by sqrt(acp_t), about 0.1 at T=6,
# which carries the two frameworks' f32 convolution roundings past 1e-5
# (6.3e-5 on this seed); chunked against unchunked in the port holds 1e-5
TOL_DDIM_JAX = 1e-4
T = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(**diffusion):
    diff = {"image_size": 16, "channels": 3, "conditional": True}
    diff.update(diffusion)
    return {
        "model": {
            "which_model_G": "sr3",
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 16,
                     "norm_groups": 4, "channel_multiplier": [1, 2], "attn_res": [8],
                     "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {p: {"schedule": "cosine", "n_timestep": T,
                                  "linear_start": 1e-6, "linear_end": 1e-2}
                              for p in ("train", "val")},
            "diffusion": diff,
        },
        "train": {"optimizer": {"type": "adam", "lr": 1e-4}},
        "path": {},
    }


@pytest.fixture(scope="module")
def weights():
    """Seeded UNet weights of ``_opt``'s model, as a state_dict and as the
    JAX package's variables."""
    unet = randomize(DDPMModel(_opt(), device="cpu").unet, 3)
    junet, _ = j_define_G(_opt())
    variables = jax_variables(junet, unet, np.zeros((1, 16, 16, 6), np.float32),
                              np.zeros((1, 1), np.float32))
    return unet.state_dict(), variables


def _model(weights, **diffusion):
    ddpm = DDPMModel(_opt(**diffusion), device="cpu")
    ddpm.unet.load_state_dict(weights[0])
    return ddpm


def _draws(n=4, seed=0):
    rng = np.random.RandomState(seed)
    cond = rng.randn(n, 16, 16, 3).astype(np.float32)
    return cond, rng.randn(n, 16, 16, 3).astype(np.float32), rng.randn(T, n, 16, 16, 3).astype(
        np.float32)


# ------------------------------------------------------------ latent_chunk


CHAINS = {"ancestral_t_start": {"t_start": 3}, "ddim": {"sampler": "ddim", "ddim_steps": 4}}


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chunked_chain_matches_jax_per_chunk(weights, chain):
    """The port's chunked chain against the JAX package's chain run on each
    chunk with the chunk's draws, as its lax.map runs one() on each."""
    diffusion = CHAINS[chain]
    cond, x_init, noise = _draws()
    opt = _opt(**diffusion)
    junet, _ = j_define_G(opt)
    jd = j_diffusion(opt, "val")

    def denoise(x, t):
        return junet.apply(weights[1], x, t)

    want = []
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    for k, part in zip(keys, (slice(0, 2), slice(2, 4))):
        if chain == "ddim":
            # the JAX DDIM takes no x_init: the port replays the chunk key's x_T
            # (eta 0 draws no step noise)
            x_init[part] = np.asarray(jax.random.normal(jax.random.split(k)[0], (2, 16, 16, 3)))
            want.append(jd.ddim_sample_loop(denoise, k, cond=cond[part], steps=4))
        else:
            want.append(jd.sample_loop(denoise, k, cond=cond[part], x_init=x_init[part],
                                       noise_seq=noise[:, part], t_start=3))
    ddpm = _model(weights, latent_chunk=2, **diffusion)
    assert ddpm._latent_chunk(4) == 2
    got = ddpm.super_resolution(cond, x_init=x_init, noise_seq=noise).numpy()
    tol = TOL_DDIM_JAX if chain == "ddim" else TOL
    np.testing.assert_allclose(got, np.concatenate([np.asarray(w) for w in want]),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_chunked_equals_unchunked_from_the_same_draws(weights, chain):
    cond, x_init, noise = _draws(6, seed=1)
    chunked = _model(weights, latent_chunk=3, **CHAINS[chain])
    whole = _model(weights, **CHAINS[chain])
    got = chunked.super_resolution(cond, x_init=x_init, noise_seq=noise)
    want = whole.super_resolution(cond, x_init=x_init, noise_seq=noise)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_chunks_draw_from_one_derived_generator_each(weights):
    """With t_start, chunk k's init_from_cond and its steps draw from the
    k-th of split_generator's generators, on that chunk's cond."""
    cond, _, _ = _draws(4, seed=2)
    ddpm = _model(weights, latent_chunk=2, t_start=3)
    got = ddpm.super_resolution(cond, generator=torch.Generator().manual_seed(5))
    whole = _model(weights, t_start=3)
    gens = split_generator(torch.Generator().manual_seed(5), 2)
    want = torch.cat([whole.super_resolution(cond[2 * k:2 * k + 2], generator=g)
                      for k, g in enumerate(gens)])
    assert torch.equal(got, want)
    again = ddpm.super_resolution(cond, generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, again)


@pytest.mark.parametrize("case", ["indivisible", "not_larger", "continous", "unconditional"])
def test_chunk_falls_back_to_the_whole_batch(weights, case):
    """The JAX package's rule: the chunk counts only for a conditional,
    non-continous chain over a batch larger than the chunk and divisible
    by it; otherwise the chain is the unchunked one, draw for draw."""
    if case == "unconditional":
        opt = _opt(latent_chunk=1)
        opt["model"]["diffusion"]["conditional"] = False
        opt["model"]["unet"]["in_channel"] = 3
        models = [DDPMModel(o, device="cpu") for o in (opt, copy.deepcopy(opt))]
        del models[1].opt["model"]["diffusion"]["latent_chunk"]
        models[1].unet.load_state_dict(models[0].unet.state_dict())
        assert models[0]._latent_chunk(2, unconditional=True) == 0
        a, b = (m.sample(2, generator=torch.Generator().manual_seed(1)) for m in models)
        assert torch.equal(a, b)
        return
    n, chunk = {"indivisible": (3, 2), "not_larger": (2, 2), "continous": (4, 2)}[case]
    cond, _, _ = _draws(n, seed=3)
    chunked = _model(weights, latent_chunk=chunk, t_start=3)
    whole = _model(weights, t_start=3)
    continous = case == "continous"
    assert chunked._latent_chunk(n, continous=continous) == 0
    a, b = (m.super_resolution(cond, generator=torch.Generator().manual_seed(4),
                               continous=continous) for m in (chunked, whole))
    assert a.shape == ((1 + 3) * n if continous else n, 16, 16, 3)
    assert torch.equal(a, b)


# ------------------------------------------------------------------ remat


def _remat_nets(remat, **kw):
    """tests/test_remat.py's UNet on both sides, on the same seeded weights."""
    cfg = dict(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4,
               channel_mults=(1, 2), attn_res=(8,), res_blocks=1, image_size=16, **kw)
    net = randomize(UNet(**cfg), 5)
    jnet = JUNet(remat=remat, **cfg)
    variables = jax_variables(jnet, net, np.zeros((1, 16, 16, 6), np.float32),
                              np.zeros((1, 1), np.float32))
    return jnet, variables, load_jax_params(UNet(remat=remat, **cfg), variables)


def _input():
    x = np.random.RandomState(0).rand(1, 16, 16, 6).astype(np.float32)
    return x, np.zeros((1, 1), np.float32)


def test_remat_same_function():
    """tests/test_remat.py:test_remat_same_function: with autograd on, as
    the remat path runs only then."""
    x, t = _input()
    jnet, variables, net = _remat_nets(True)
    _, _, plain = _remat_nets(False)
    want = np.asarray(jax.jit(jnet.apply)(variables, x, t))
    with mock.patch.object(unet_mod, "checkpoint", wraps=unet_mod.checkpoint) as spy:
        got = net(torch.from_numpy(x), torch.from_numpy(t))
    # every ResnetBlocWithAttn: 2 down, 2 mid, 4 up
    assert got.requires_grad and spy.call_count == 8
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-6)
    np.testing.assert_allclose(plain(torch.from_numpy(x), torch.from_numpy(t)).detach().numpy(),
                               got.detach().numpy(), atol=2e-6)


def _grads(net, x, t):
    net.zero_grad(set_to_none=True)
    (net(torch.from_numpy(x), torch.from_numpy(t)) ** 2).sum().backward()
    return {n: p.grad.detach().clone() for n, p in net.named_parameters()}


def test_remat_gradients():
    """tests/test_remat.py:test_remat_gradients: the port's remat gradients
    against the JAX package's remat gradients and the port's own without
    remat, each leaf to atol 1e-4, rtol 1e-3."""
    x, t = _input()
    jnet, variables, net = _remat_nets(True)
    g = jax.jit(jax.grad(lambda p: (jnet.apply({"params": p}, x, t) ** 2).sum()))(
        variables["params"])
    tmp = _remat_nets(False)[2]
    load_jax_params(tmp, {"params": g})  # the JAX gradient tree in the port's layout
    want = {n: p.detach() for n, p in tmp.named_parameters()}
    got = _grads(net, x, t)
    plain = _grads(_remat_nets(False)[2], x, t)
    assert got.keys() == want.keys()
    for n in got:
        assert torch.isfinite(got[n]).all(), n
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)
        np.testing.assert_allclose(got[n].numpy(), plain[n].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)


def _train_opt(remat, dropout=0.2):
    opt = _opt()
    opt["model"]["unet"].update(remat=remat, dropout=dropout)
    return opt


def _step(opt, state, batch, seed):
    ddpm = DDPMModel(opt, device="cpu")
    ddpm.unet.load_state_dict(state)
    g = torch.Generator().manual_seed(seed)
    loss = ddpm.compute_grads(batch, generator=g)
    return ddpm, loss, g


def test_remat_keeps_the_dropout_masks():
    """Dropout 0.2, the step's generator seeded alike: the step with remat
    (read from model.unet.remat) is the step without it, and leaves the
    generator where it leaves it. Without the replay the recompute would
    draw new masks from the moved generator."""
    state = randomize(DDPMModel(_train_opt(False), device="cpu").unet, 6).state_dict()
    rng = np.random.RandomState(7)
    batch = {k: rng.randn(2, 16, 16, 3).astype(np.float32) for k in ("HR", "SR")}
    plain, loss0, g0 = _step(_train_opt(False), state, batch, 8)
    remat, loss1, g1 = _step(_train_opt(True), state, batch, 8)
    assert remat.unet.remat and not plain.unet.remat
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-6)
    for (n, p0), p1 in zip(plain.unet.named_parameters(), remat.unet.parameters()):
        np.testing.assert_allclose(p1.grad.numpy(), p0.grad.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)
    assert torch.equal(g0.get_state(), g1.get_state())
    # the masks matter: another dropout seed moves the gradients
    other, _, _ = _step(_train_opt(True), state, batch, 9)
    assert not torch.allclose(other.unet.final_conv.block[3].weight.grad,
                              remat.unet.final_conv.block[3].weight.grad)


def test_remat_moves_batchnorm_statistics_once():
    """The BatchNorm UNet ('ddpm'): after one step with remat its running
    statistics (and counts) are those after the step without it."""
    kw = dict(in_channel=3, out_channel=3, inner_channel=8, norm_groups=4, channel_mults=(1, 2),
              attn_res=(8,), res_blocks=1, image_size=16, dropout=0.2,
              time_embedding="discrete", norm="batch")
    nets = [UNet(remat=r, **kw).train() for r in (False, True)]
    randomize(nets[0], 10)
    nets[1].load_state_dict(nets[0].state_dict())
    x = torch.from_numpy(np.random.RandomState(11).randn(2, 16, 16, 3).astype(np.float32))
    t = torch.tensor([3, 7], dtype=torch.int32)
    for net in nets:
        net.set_dropout_generator(torch.Generator().manual_seed(12))
        (net(x, t) ** 2).mean().backward()
    stats = [{k: v for k, v in n.state_dict().items() if "running" in k or "num_batches" in k}
             for n in nets]
    assert stats[0].keys() == stats[1].keys() and len(stats[0]) > 0
    for k in stats[0]:
        assert torch.equal(stats[0][k], stats[1][k]), k
    assert int(nets[1].final_conv.block[0].num_batches_tracked) == 1
    for (n, p0), p1 in zip(nets[0].named_parameters(), nets[1].parameters()):
        np.testing.assert_allclose(p1.grad.numpy(), p0.grad.numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=n)


def test_remat_changes_nothing_without_autograd(weights):
    """At inference (no autograd) remat does not run: the function is the
    plain forward's, bit for bit."""
    x = torch.from_numpy(np.random.RandomState(13).randn(2, 16, 16, 6).astype(np.float32))
    t = torch.full((2, 1), 0.4)
    plain = _model(weights).unet
    opt = _opt()
    opt["model"]["unet"]["remat"] = True
    remat = DDPMModel(opt, device="cpu").unet
    remat.load_state_dict(weights[0])
    with mock.patch.object(unet_mod, "checkpoint", wraps=unet_mod.checkpoint) as spy, \
            torch.no_grad():
        assert torch.equal(remat(x, t), plain(x, t))
    assert spy.call_count == 0
