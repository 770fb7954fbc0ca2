"""The port's whole-scene tiled inference (``super_resolve_tiled``) and the
offline crops it replaces (``data/crop.py``) against the JAX package.

Both pipelines are built on the same seeded GAE and UNet weights (through
the bridge), in the shape of ``tests/test_torch_pipeline.py``'s tiny
settings with ``t_start``. At the sizes of ``tests/test_pipeline.py``'s
tiled cases (40x40, 40x12 and 12x40 with tile 16 and overlap 8), each
tile replays the same x_init and noise on both sides: each instance's
``super_resolve`` is swapped in the test for a replay of tile k's draws.
Tolerance 1e-5: f32 convolutions in another order, averaged over the
overlaps.
"""

import os
from types import SimpleNamespace
from unittest import mock

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch

from hsi_dmgasr_tpu.data import crop as jcrop
from hsi_dmgasr_tpu.models import GAE as JGAE
from hsi_dmgasr_tpu.models.networks import define_G as j_define_G
from hsi_dmgasr_tpu.models.networks import diffusion_for_phase as j_diffusion
from hsi_dmgasr_tpu.pipeline import DMGASRPipeline as JPipeline
from hsi_dmgasr_tpu_torch.data import crop
from hsi_dmgasr_tpu_torch.diffusion import split_generator
from hsi_dmgasr_tpu_torch.models.gae import GAE
from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
from torch_port_weights import jax_variables, randomize

TOL = 1e-5
T, T_START = 6, 3
GAE_CFG = {"n_subs": 8, "n_ovls": 2, "n_colors": 31, "n_feats": 16, "G": 5}
GAE_KW = {k: GAE_CFG[k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")}
OPT = {
    "gae": {"latent_shift": -0.3, "latent_scale": 2.0},
    "model": {
        "which_model_G": "sr3",
        "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 16, "norm_groups": 4,
                 "channel_multiplier": [1, 2], "attn_res": [8], "res_blocks": 1,
                 "dropout": 0.0},
        "beta_schedule": {p: {"schedule": "cosine", "n_timestep": T, "linear_start": 1e-6,
                              "linear_end": 1e-2} for p in ("train", "val")},
        "diffusion": {"image_size": 16, "channels": 3, "conditional": True,
                      "t_start": T_START},
    },
    "train": {"optimizer": {"type": "adam", "lr": 1e-4}},
    "path": {},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) on the same seeded weights."""
    gae = randomize(GAE(**GAE_KW), 1)
    gae_vars = jax_variables(JGAE(**GAE_KW), gae, np.zeros((1, 16, 16, 31), np.float32))
    ddpm = DDPMModel(OPT, device="cpu")
    randomize(ddpm.unet, 2)
    junet, _ = j_define_G(OPT)
    unet_vars = jax_variables(junet, ddpm.unet, np.zeros((1, 16, 16, 6), np.float32),
                              np.zeros((1, 1), np.float32))
    jpipe = JPipeline(OPT, gae_vars, GAE_CFG, ddpm=SimpleNamespace(
        unet=junet, variables=unet_vars, val_diffusion=j_diffusion(OPT, "val")))
    return jpipe, DMGASRPipeline(OPT, gae.state_dict(), GAE_CFG, ddpm=ddpm, device="cpu")


def _tile_draws(shape, tile, overlap, seed):
    """One (x_init, noise_seq) per tile, in row-major tile order, shaped
    as each tile's folded latent (G, h, w, 3)."""
    rng = np.random.RandomState(seed)
    stride = tile - overlap

    def origins(dim):
        return sorted({max(0, min(o, dim - tile)) for o in range(0, max(dim - overlap, 1), stride)})

    draws = []
    for y0 in origins(shape[0]):
        for x0 in origins(shape[1]):
            hw = (min(tile, shape[0] - y0), min(tile, shape[1] - x0))
            draws.append((rng.randn(GAE_CFG["G"], *hw, 3).astype(np.float32),
                          rng.randn(T_START, GAE_CFG["G"], *hw, 3).astype(np.float32)))
    return draws


def _jax_tile_replay(jpipe, draws):
    """A stand-in for the JAX instance's super_resolve: tile k's call runs
    the pipeline's encode, its sampler from tile k's draws, decode, clip."""
    calls = iter(draws)
    d = jpipe.ddpm
    chain = jax.jit(lambda cond, x_init, noise: d.val_diffusion.sample_loop(
        lambda x, t: d.unet.apply(d.variables, x, t), jax.random.PRNGKey(0), cond=cond,
        x_init=x_init, noise_seq=noise, t_start=T_START))

    def super_resolve(patch, key=None):
        x_init, noise = next(calls)
        z = chain(jpipe._fold(jpipe.encode(patch)), x_init, noise)
        return np.clip(np.asarray(jpipe.decode(jpipe._unfold(z, 1))), 0, 1)

    return super_resolve


def _torch_tile_replay(pipe, draws):
    """A stand-in for the port's super_resolve: tile k's call is the real
    one, replaying tile k's draws."""
    calls = iter(draws)
    real = pipe.super_resolve

    def super_resolve(patch, generator=None):
        x_init, noise = next(calls)
        return real(patch, x_init=x_init, noise_seq=noise)

    return super_resolve


@pytest.mark.parametrize("shape", [(40, 40, 31), (40, 12, 31), (12, 40, 31)])
def test_tiled_matches_jax(pipelines, shape):
    jpipe, pipe = pipelines
    scene = np.random.RandomState(5).rand(*shape).astype(np.float32)
    draws = _tile_draws(shape, 16, 8, seed=6)
    assert len(draws) == {(40, 40, 31): 16}.get(shape, 4)
    with mock.patch.object(jpipe, "super_resolve", _jax_tile_replay(jpipe, draws)):
        want = np.asarray(jpipe.super_resolve_tiled(scene, tile=16, overlap=8,
                                                    key=jax.random.PRNGKey(9)))
    with mock.patch.object(pipe, "super_resolve", _torch_tile_replay(pipe, draws)):
        got = pipe.super_resolve_tiled(scene, tile=16, overlap=8)
    assert got.shape == shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_tiles_draw_from_split_generators(pipelines):
    """Tile k is super_resolve of its patch drawing from
    the k-th of split_generator's generators; a seed gives one scene."""
    _, pipe = pipelines
    scene = torch.from_numpy(np.random.RandomState(7).rand(24, 20, 31).astype(np.float32))
    outs = []

    def keep(*args, **kw):
        outs.append(real(*args, **kw))
        return outs[-1]

    real = pipe.super_resolve
    with mock.patch.object(pipe, "super_resolve", keep):
        got = pipe.super_resolve_tiled(scene, tile=16, overlap=8,
                                       generator=torch.Generator().manual_seed(3))
    tiles = [(y, x) for y in (0, 8) for x in (0, 4)]
    assert len(outs) == len(tiles)
    for (y0, x0), g, out in zip(tiles, split_generator(torch.Generator().manual_seed(3), 4), outs):
        assert torch.equal(out, real(scene[None, y0:y0 + 16, x0:x0 + 16], generator=g))
    again = pipe.super_resolve_tiled(scene[None], tile=16, overlap=8,
                                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, again)
    assert got.min() >= 0 and got.max() <= 1
    with pytest.raises(ValueError, match="one scene"):
        pipe.super_resolve_tiled(torch.stack([scene, scene]), tile=16)


@pytest.mark.parametrize("shape", [(16, 12, 31), (10, 16, 31)])
def test_tile_covering_the_scene_is_super_resolve(pipelines, shape):
    _, pipe = pipelines
    scene = torch.from_numpy(np.random.RandomState(8).rand(*shape).astype(np.float32))
    got = pipe.super_resolve_tiled(scene, tile=16, overlap=8,
                                   generator=torch.Generator().manual_seed(4))
    want = pipe.super_resolve(scene[None], generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(got, want)


def test_corner_center_crops_match_jax():
    img = np.random.RandomState(9).rand(37, 29, 4).astype(np.float32)
    got, want = crop.corner_center_crops(img, 16), jcrop.corner_center_crops(img, 16)
    assert got.keys() == want.keys() == {"tl", "tr", "bl", "br", "center"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="smaller than crop"):
        crop.corner_center_crops(img, 30)


@pytest.mark.parametrize("ext", [".npy", ".mat"])
def test_crop_cli_writes_five_crops(tmp_path, ext):
    img = np.random.RandomState(10).rand(20, 24, 3).astype(np.float64)
    src = str(tmp_path / f"scene{ext}")
    if ext == ".npy":
        np.save(src, img)
    else:
        sio.savemat(src, {"block": img})
    out = tmp_path / "crops"
    crop.main(["--input", src, "--size", "8", "--out", str(out)])
    want = jcrop.corner_center_crops(img, 8)
    assert sorted(os.listdir(out)) == sorted(f"scene_{k}.npy" for k in want)
    for k, v in want.items():
        saved = np.load(out / f"scene_{k}.npy")
        assert saved.dtype == np.float32
        np.testing.assert_array_equal(saved, v.astype(np.float32))
