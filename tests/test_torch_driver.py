"""The port's stage-2 driver, config and CLI on the CPU: the tiny
end-to-end loop of tests/test_stage2_driver.py (host batches and the
device-resident branch), a resume that continues the step counter, the
rolling best snapshot, pruning, the GAE loader and the -p val phase.

The JAX driver's tests need the shipped whole-module GAE pickle; the
port's take a seeded GAE saved as a state_dict."""

import json
import os

import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu_torch import config as C
from hsi_dmgasr_tpu_torch.cli import sr_gae
from hsi_dmgasr_tpu_torch.io.convert_torch import export_jax_params
from hsi_dmgasr_tpu_torch.models.gae import GAE
from hsi_dmgasr_tpu_torch.models.networks import init_weights
from hsi_dmgasr_tpu_torch.train import stage2_driver


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: torch's thread pool only spins against the other test
    workers of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GAE_KW = dict(n_subs=8, n_ovls=2, n_colors=31, n_feats=16)


@pytest.fixture(scope="module")
def gae_pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("gae") / "gae.pth"
    torch.save(init_weights(GAE(**GAE_KW), torch.Generator().manual_seed(0)).state_dict(), path)
    return str(path)


def _cfg(synth_data, gae_pth, n_iter=2, val_freq=2, device_resident=False, **train):
    return {
        "name": "drv", "gpu_ids": [0], "scale": 2,
        "path": {"log": "logs", "results": "results", "checkpoint": "checkpoint",
                 "tb_logger": "tb"},
        "gae": dict(checkpoint=gae_pth, **GAE_KW),
        "datasets": {
            "train": {"dataroot": os.path.join(synth_data, "mat_scenes"), "datatype": "hsi_mat",
                      "l_resolution": 16, "batch_size": 2, "use_shuffle": True, "data_len": 4,
                      "device_resident": device_resident},
            "val": {"dataroot": os.path.join(synth_data, "npy_scenes"), "datatype": "hsi_npy",
                    "r_resolution": 32, "data_len": 1},
        },
        "model": {
            "which_model_G": "sr3", "finetune_norm": False,
            "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8, "norm_groups": 4,
                     "channel_multiplier": [1, 2], "attn_res": [8], "res_blocks": 1,
                     "dropout": 0.1},
            "beta_schedule": {p: {"schedule": "cosine", "n_timestep": 3, "linear_start": 1e-6,
                                  "linear_end": 1e-2} for p in ("train", "val")},
            "diffusion": {"image_size": 32, "channels": 3, "conditional": True, "t_start": 2},
        },
        "train": dict({"n_iter": n_iter, "val_freq": val_freq, "save_checkpoint_freq": 2,
                       "print_freq": 1, "val_chains": 2,
                       "optimizer": {"type": "adam", "lr": 1e-4,
                                     "lr_schedule": {"type": "cosine", "decay_steps": 4}},
                       "ema_scheduler": {"ema_decay": 0.99, "use_ema_for_eval": True}},
                      **train),
    }


def _parse(tmp_path, cfg, name="cfg.json"):
    path = tmp_path / name
    path.write_text(json.dumps(cfg))
    return C.parse(str(path), phase="train", experiments_root=str(tmp_path / "exp"))


@pytest.mark.parametrize("device_resident", [False, True])
def test_train_loop_end_to_end(synth_data, gae_pth, tmp_path, device_resident):
    opt = _parse(tmp_path, _cfg(synth_data, gae_pth, device_resident=device_resident))
    pipeline, results = stage2_driver.train(opt, seed=0, device="cpu")
    # parse sets the val data_len to 3 in the train phase; synth_data has 2 scenes
    assert pipeline.ddpm.step == 2 and results["n_chains"] == 2 and results["n"] == 2
    for k in ("MPSNR", "MSSIM", "SAM"):
        assert np.isfinite(results["indices"][k]) and np.isfinite(results["indices_cc"][k])
    ckpts = os.listdir(opt["path"]["checkpoint"])
    assert "I2_E1" in ckpts and "best_I2_E1" in ckpts
    assert os.path.exists(os.path.join(opt["path"]["checkpoint"], "I2_E1", "state.pt"))
    best = stage2_driver._read_best(opt["path"]["checkpoint"])
    assert best["name"] == "best_I2_E1" and np.isfinite(best["value"])
    dumps = os.listdir(os.path.join(opt["path"]["results"], "1"))
    assert sorted(dumps) == ["2_1_hr.npy", "2_1_sr.npy", "2_2_hr.npy", "2_2_sr.npy"]
    assert os.path.exists(os.path.join(opt["path"]["log"], "train.log"))
    # -p val with no resume_state evaluates the best snapshot
    opt_val = dict(opt)
    opt_val["path"] = dict(opt["path"], resume_state=None)
    res_val = stage2_driver.run_val_phase(opt_val, seed=0, device="cpu")
    assert opt_val["path"]["resume_state"].endswith("best_I2_E1")
    np.testing.assert_allclose(res_val["indices_cc"]["MPSNR"], best["value"], rtol=1e-6)


def test_resume_continues_step_counter(synth_data, gae_pth, tmp_path):
    cfg = _cfg(synth_data, gae_pth, val_freq=100, keep_checkpoints=1)
    opt = _parse(tmp_path, cfg)
    pipeline, _ = stage2_driver.train(opt, seed=0, device="cpu")
    ckpt = os.path.join(opt["path"]["checkpoint"], "I2_E1")
    params_2 = {k: v.clone() for k, v in pipeline.ddpm.unet.state_dict().items()}

    opt2 = _parse(tmp_path, cfg)
    opt2["path"]["resume_state"] = ckpt
    opt2["train"]["n_iter"] = 4
    pipeline2, _ = stage2_driver.train(opt2, seed=0, device="cpu")
    assert (pipeline2.ddpm.begin_step, pipeline2.ddpm.begin_epoch, pipeline2.ddpm.step) == (2, 1, 4)
    assert sorted(os.listdir(opt2["path"]["checkpoint"])) == ["I4_E2"]  # keep_checkpoints 1
    moved = any(not torch.equal(pipeline2.ddpm.unet.state_dict()[k], v)
                for k, v in params_2.items())
    assert moved


def test_cli_trains_and_validates_on_the_cpu(synth_data, gae_pth, tmp_path):
    path = tmp_path / "cli.json"
    path.write_text(json.dumps(_cfg(synth_data, gae_pth)))
    root = str(tmp_path / "cli_exp")
    pipeline, results = sr_gae.main(["-c", str(path), "-p", "train", "--device", "cpu",
                                     "--experiments_root", root])
    assert pipeline.ddpm.step == 2 and np.isfinite(results["indices"]["MPSNR"])
    res = sr_gae.main(["-c", str(path), "-p", "val", "--device", "cpu",
                       "--experiments_root", root])
    assert np.isfinite(res["indices"]["MPSNR"])


def test_best_checkpoint_rolls(tmp_path):
    class _FakeDDPM:
        def save_checkpoint(self, ckpt_dir, epoch, it, name=None):
            path = os.path.join(ckpt_dir, name or f"I{it}_E{epoch}")
            os.makedirs(path)
            return path

        def export_params_npz(self, path):
            open(path, "w").close()

    class _FakePipeline:
        ddpm = _FakeDDPM()

    d = str(tmp_path)
    assert stage2_driver._read_best(d) is None
    stage2_driver.save_best_checkpoint(_FakePipeline(), d, 1, 500, 20.0)
    assert stage2_driver._read_best(d)["value"] == 20.0
    export = tmp_path / "export"
    export.mkdir()
    stage2_driver.save_best_checkpoint(_FakePipeline(), d, 2, 1500, 23.5, export_dir=str(export))
    best = stage2_driver._read_best(d)
    assert best["name"] == "best_I1500_E2" and best["value"] == 23.5
    assert not os.path.exists(os.path.join(d, "best_I500_E1"))
    assert sorted(os.listdir(export)) == ["best.json", "best_params.npz"]


def test_prune_periodic_checkpoints(tmp_path):
    for n in ["I500_E32", "I1000_E63", "I9500_E594", "I10000_E625", "best_I9500_E594"]:
        (tmp_path / n).mkdir()
    (tmp_path / "best.json").write_text("{}")
    stage2_driver.prune_periodic_checkpoints(str(tmp_path), keep=2)
    left = sorted(p.name for p in tmp_path.iterdir())
    assert left == ["I10000_E625", "I9500_E594", "best.json", "best_I9500_E594"]
    stage2_driver.prune_periodic_checkpoints(str(tmp_path), keep=0)
    assert sorted(p.name for p in tmp_path.iterdir()) == left


def test_load_gae(tmp_path, gae_pth):
    opt = {"gae": dict(checkpoint=gae_pth, **GAE_KW)}
    gae, cfg = stage2_driver.load_gae(opt)
    assert cfg == dict(GAE_KW, G=5)
    for k, v in torch.load(gae_pth, weights_only=True).items():
        assert torch.equal(gae.state_dict()[k], v), k
    # a JAX GAE param tree, as an .npz of flattened flax paths
    npz = tmp_path / "gae.npz"
    np.savez(npz, **{"params/" + "/".join(p): v for p, v in export_jax_params(gae).items()})
    back, _ = stage2_driver.load_gae({"gae": dict(checkpoint=str(npz), **GAE_KW)})
    for k, v in gae.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # a whole module that is not a reference GAE (the port's own class)
    pickle = tmp_path / "module.pth"
    torch.save(GAE(**GAE_KW), pickle)
    with pytest.raises(ValueError, match="not a reference GAE"):
        stage2_driver.load_gae({"gae": dict(checkpoint=str(pickle), **GAE_KW)})
    with pytest.raises(ValueError, match="n_ovls"):
        stage2_driver.load_gae({"gae": {"checkpoint": gae_pth, "n_subs": 8}})


def test_build_dataset_refuses_pairs(synth_data):
    """The .mat pair folders are built now (tests/test_torch_mat_folder.py
    holds their items); a datatype build_dataset does not know is refused."""
    train = stage2_driver.build_dataset(
        {"datatype": "mat_pairs_train", "dataroot": os.path.join(synth_data, "pairs", "train")},
        "train", n_scale=2)
    assert len(train) == 2 and train[0]["SR"].shape == train[0]["HR"].shape
    with pytest.raises(NotImplementedError, match="lmdb"):
        stage2_driver.build_dataset({"datatype": "lmdb", "dataroot": "x"}, "train")


def test_parse_makes_the_experiment_tree_and_debug(tmp_path, synth_data, gae_pth):
    path = tmp_path / "c.json"
    path.write_text("// a comment\n" + json.dumps(_cfg(synth_data, gae_pth)))
    opt = C.parse(str(path), phase="train", experiments_root=str(tmp_path / "e"), debug=True)
    assert opt["name"] == "debug_drv" and opt["train"]["val_freq"] == 2
    assert opt["datasets"]["train"]["batch_size"] == 2 and opt["missing"] is None
    for key in ("log", "results", "checkpoint", "tb_logger"):
        assert os.path.isdir(opt["path"][key])
    assert opt["path"]["experiments_root"] == str(tmp_path / "e")
