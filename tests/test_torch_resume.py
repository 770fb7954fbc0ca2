"""``path.resume_state`` in the port's DDPMModel against the JAX package's.

The JAX package's ``DDPMModel.load_resume`` takes an orbax directory, an
``export_params_npz`` ``.npz`` or a reference ``{prefix}_gen.pth``; the
port reads the last two and refuses the first. An ``.npz`` written by the
JAX package and named in the config gives both packages the same f16
weights, so one f32 UNet forward agrees to f32 summation order: 2e-5,
the tolerance of the f32 UNet against the torch goldens.
"""

import copy

import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.train.ddpm_model import DDPMModel as JDDPMModel
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
from torch_port_weights import randomize

OPT = {
    "gpu_ids": [0],
    "model": {
        "which_model_G": "sr3",
        "finetune_norm": False,
        "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8, "norm_groups": 4,
                 "channel_multiplier": [1, 2], "attn_res": [8], "res_blocks": 1,
                 "dropout": 0.0},
        "beta_schedule": {p: {"schedule": "cosine", "n_timestep": 4,
                              "linear_start": 1e-6, "linear_end": 1e-2}
                          for p in ("train", "val")},
        "diffusion": {"image_size": 16, "channels": 3, "conditional": True},
    },
    "train": {"optimizer": {"type": "adam", "lr": 1e-4}},
    "path": {},
}
DROPPED = ("downs.0.weight", "final_conv.block.3.weight", "final_conv.block.3.bias")


def _opt(resume):
    opt = copy.deepcopy(OPT)
    opt["path"]["resume_state"] = resume
    return opt


def _inputs():
    rng = np.random.RandomState(7)
    return rng.rand(2, 16, 16, 6).astype(np.float32), np.array([[0.3], [0.9]], np.float32)


def _forward(ddpm, x, t):
    with torch.no_grad():
        return ddpm.unet(torch.tensor(x), torch.tensor(t)).numpy()


def test_npz_export_loads_like_jax(tmp_path):
    path = JDDPMModel(OPT, seed=0).export_params_npz(str(tmp_path / "best_params.npz"))
    jddpm = JDDPMModel(_opt(path), seed=1)
    ddpm = DDPMModel(_opt(path), seed=1, device="cpu")
    x, t = _inputs()
    want = np.asarray(jddpm.unet.apply({"params": jddpm.eval_params}, x, t, train=False))
    got = _forward(ddpm, x, t)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    fresh = _forward(DDPMModel(OPT, seed=1, device="cpu"), x, t)
    assert np.abs(fresh - got).max() > 1e-2   # the weights came from the file


def test_gen_pth_drops_the_boundary_convs(tmp_path):
    """The reference checkpoint's first and last convs are dropped, and a
    leaf of another shape keeps the module's own, as JAX's merge does."""
    src = randomize(DDPMModel(OPT, seed=5, device="cpu").unet, 3)
    sd = {"denoise_fn." + k: v.clone() for k, v in src.state_dict().items()}
    sd["denoise_fn.downs.0.weight"] = torch.zeros(8, 4, 3, 3)   # other in_channel
    sd["denoise_fn.noise_level_mlp.1.bias"] = torch.zeros(5)      # other shape
    sd["denoise_fn.extra.weight"] = torch.zeros(1)               # not in the module
    torch.save(sd, tmp_path / "I10_E1_gen.pth")
    own = DDPMModel(OPT, seed=1, device="cpu").unet.state_dict()
    got = DDPMModel(_opt(str(tmp_path / "I10_E1")), seed=1, device="cpu").unet.state_dict()
    kept = set(DROPPED) | {"noise_level_mlp.1.bias"}
    for k, v in got.items():
        want = own[k] if k in kept else src.state_dict()[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    assert not torch.equal(src.state_dict()["final_conv.block.3.weight"],
                           own["final_conv.block.3.weight"])


def test_orbax_directory_raises(tmp_path):
    (tmp_path / "I100_E2").mkdir()
    with pytest.raises(ValueError, match="export_params_npz"):
        DDPMModel(_opt(str(tmp_path / "I100_E2")), device="cpu")


@pytest.mark.parametrize("name", ["missing.npz", "missing_prefix"])
def test_missing_path_raises(tmp_path, name):
    with pytest.raises(FileNotFoundError, match="resume_state"):
        DDPMModel(_opt(str(tmp_path / name)), device="cpu")
