"""Stage-2 DMGASR train/val driver (reference sr_gae.py:127-583).

Port of ``hsi_dmgasr_tpu/train/stage2_driver.py``:

  * the GAE is loaded once and stays frozen (the reference torch.load()s
    it from disk every batch, sr_gae.py:228);
  * per-batch training folds the G groups into one optimizer step
    (``train.per_group_steps`` restores the reference's G steps);
  * ``datasets.train.device_resident``: the normalised scenes live on the
    card and each step's crops, augmentation and degradation are made
    there (``data/device_cache.py``);
  * validation super-resolves each scene ``train.val_chains`` times with
    a seeded generator per (scene, chain) and averages the raw and
    colour-corrected metric suites over the chains;
  * a periodic save comes before the validation of the same step; a best
    snapshot ``best_I{it}_E{ep}`` is tracked by ``best.json``; periodic
    saves are pruned to ``train.keep_checkpoints``.

Scalars are logged through ``logging`` (the JAX package's TensorBoard and
W&B loggers are not ported), and validation writes the ``.npy`` dumps
only: the PNG dumps wait for a port of ``evalhsi/image_io.py``.
Datatypes: ``hsi_mat``, ``hsi_npy``, and the ``.mat`` pair folders
``mat_pairs_train`` and ``mat_pairs_test`` (``data/mat_folder.py``).
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import shutil
import time

import numpy as np
import torch

from ..config import setup_logger
from ..data.device_cache import DeviceSceneCache
from ..data.hs_datasets import HSTestData, HSTrainingData
from ..data.loader import DataLoader
from ..data.mat_folder import TestsetFromFolder, TrainsetFromFolder
from ..device import resolve_device, use_f32_policy
from ..evalhsi.metrics import color_correction, quality_assessment, sum_dict
from ..io.convert_torch import load_jax_params, load_state_dict, load_torch_gae, unflatten_npz
from ..models.gae import GAE
from ..pipeline import DMGASRPipeline
from .ddpm_model import DDPMModel
from .stage1_gae import GAETrainer

logger = logging.getLogger("base")
_GAE_KEYS = ("n_subs", "n_ovls", "n_colors", "n_feats")


def load_gae(opt):
    """(GAE module, config) from the config's ``gae`` section.
    ``gae.checkpoint`` is what stage 1 produces, or a JAX export:

      * a directory written by ``GAETrainer.save`` (the port's stage 1);
      * a whole-module ``.pth`` (the shipped ``GAE_*.pth``), through
        ``load_torch_gae``;
      * a reference-layout state_dict ``.pth``, or a JAX GAE param ``.npz``.

    A checkpoint that carries its own widths takes them from there, and an
    ``n_subs``, ``n_ovls``, ``n_colors`` or ``n_feats`` in the section that
    differs is an error. The other two kinds need all four in the
    section."""
    gae_opt = opt.get("gae") or {}
    ckpt = gae_opt.get("checkpoint")
    if not ckpt:
        raise ValueError("config['gae']['checkpoint'] is required")
    sd = own = None
    if os.path.isdir(ckpt):
        sd, own = GAETrainer.load_gae_variables(ckpt)
    elif ckpt.endswith(".pth"):
        try:
            sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:  # not a state_dict: a whole-module pickle
            sd, own = load_torch_gae(ckpt)
    elif not ckpt.endswith(".npz"):
        raise ValueError(f"gae.checkpoint {ckpt}: expected a stage-1 directory, a .pth or a "
                         "JAX .npz")
    if own is not None:
        clash = {k: (gae_opt[k], own[k]) for k in _GAE_KEYS
                 if gae_opt.get(k) is not None and int(gae_opt[k]) != own[k]}
        if clash:
            raise ValueError(f"config['gae'] disagrees with {ckpt} (config, checkpoint): {clash}")
        cfg = {k: int(own[k]) for k in _GAE_KEYS}
    else:
        missing = [k for k in _GAE_KEYS if gae_opt.get(k) is None]
        if missing:
            raise ValueError(f"config['gae'] needs {missing} beside the checkpoint")
        cfg = {k: int(gae_opt[k]) for k in _GAE_KEYS}
    cfg["G"] = -(-(cfg["n_colors"] - cfg["n_ovls"]) // (cfg["n_subs"] - cfg["n_ovls"]))
    gae = GAE(**{k: cfg[k] for k in _GAE_KEYS})
    if sd is None:
        load_jax_params(gae, unflatten_npz(ckpt))
    else:
        load_state_dict(gae, sd)
    return gae, cfg


def build_dataset(ds_opt, phase, n_scale=4):
    datatype = ds_opt.get("datatype", "hsi_mat")
    root = ds_opt["dataroot"]
    n_scale = ds_opt.get("n_scale") or n_scale
    if datatype == "hsi_mat" and phase == "train":
        return HSTrainingData(root, n_scale=n_scale,
                              augment=bool(ds_opt.get("augment", True)),
                              base_size=ds_opt.get("l_resolution") or 32,
                              hr_only=bool(ds_opt.get("on_device_degradation")))
    if datatype in ("hsi_mat", "hsi_npy"):
        return HSTestData(root, n_scale=n_scale, gt_size=ds_opt.get("r_resolution") or 64)
    if datatype == "mat_pairs_train":
        return TrainsetFromFolder(root, scale=n_scale)
    if datatype == "mat_pairs_test":
        return TestsetFromFolder(root, scale=n_scale, lr_size=ds_opt.get("l_resolution") or 32,
                                 hr_size=ds_opt.get("r_resolution") or 128)
    raise NotImplementedError(f"datatype [{datatype}]")


class _Limited:
    def __init__(self, inner, n):
        self.inner, self.n = inner, min(n, len(inner))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.inner[i]


def _limit(ds, data_len):
    return _Limited(ds, data_len) if data_len and data_len > 0 else ds


def build_pipeline(opt, seed=0, device=None):
    gae, gae_cfg = load_gae(opt)
    dev = resolve_device(device)
    ddpm = DDPMModel(opt, seed=seed, device=dev)
    pipeline = DMGASRPipeline(opt, gae.state_dict(), gae_cfg, ddpm=ddpm, seed=seed, device=dev)
    return pipeline


def derive_seed(*parts):
    """One 32-bit seed from integers (numpy's SeedSequence)."""
    return int(np.random.SeedSequence([int(p) & 0xFFFFFFFF for p in parts]).generate_state(1)[0])


def validate(pipeline, val_loader, opt, result_path=None, step=0, save_outputs=True,
             ratio=4, n_chains=None):
    """One validation sweep (sr_gae.py:275-411): metrics raw and colour-
    corrected, per-cube timing, ``.npy`` dumps. Each scene runs
    ``n_chains`` (``train.val_chains``, default 3) reverse chains, each
    from a generator seeded by (manual_seed, scene, chain): stable across
    restarts, so best-val comparisons at different steps see the same
    draws. The chain-to-chain std of the scene-averaged MPSNR is reported
    beside the means."""
    if n_chains is None:
        n_chains = int((opt.get("train") or {}).get("val_chains") or 3)
    n_chains = max(1, n_chains)
    base = int(opt.get("manual_seed") or 0) + 0x9173
    indices = indices_cc = None
    total_time, idx = 0.0, 0
    chain_psnr = np.zeros(n_chains)
    chain_psnr_cc = np.zeros(n_chains)
    if result_path:
        os.makedirs(result_path, exist_ok=True)
    dev = pipeline.device
    for val_data in val_loader:
        idx += 1
        sr_cube = val_data["SR"]
        gt = np.asarray(val_data["HR"])[0]
        scene_qa = scene_qa_cc = None
        for chain in range(n_chains):
            gen = torch.Generator(device=dev).manual_seed(derive_seed(base, idx, chain))
            t0 = time.time()
            pred = pipeline.super_resolve(sr_cube, generator=gen).cpu().numpy()
            total_time += time.time() - t0

            y = pred[0]
            qa = quality_assessment(gt, y, data_range=1.0, ratio=ratio)
            scene_qa = qa if scene_qa is None else sum_dict(scene_qa, qa)
            y_cc = color_correction(gt, y, num_channels=gt.shape[-1])
            qa_cc = quality_assessment(gt, y_cc, data_range=1.0, ratio=ratio)
            scene_qa_cc = qa_cc if scene_qa_cc is None else sum_dict(scene_qa_cc, qa_cc)
            chain_psnr[chain] += qa["MPSNR"]
            chain_psnr_cc[chain] += qa_cc["MPSNR"]
            if chain == 0 and result_path and save_outputs:
                np.save(f"{result_path}/{step}_{idx}_hr.npy", gt)
                np.save(f"{result_path}/{step}_{idx}_sr.npy", y_cc)
        scene_qa = {k: v / n_chains for k, v in scene_qa.items()}
        scene_qa_cc = {k: v / n_chains for k, v in scene_qa_cc.items()}
        indices = scene_qa if indices is None else sum_dict(indices, scene_qa)
        indices_cc = scene_qa_cc if indices_cc is None else sum_dict(indices_cc, scene_qa_cc)

    indices = {k: v / idx for k, v in indices.items()}
    indices_cc = {k: v / idx for k, v in indices_cc.items()}
    chain_psnr /= idx
    chain_psnr_cc /= idx
    return {"indices": indices, "indices_cc": indices_cc,
            "mpsnr_std": float(np.std(chain_psnr)), "mpsnr_cc_std": float(np.std(chain_psnr_cc)),
            "n_chains": n_chains, "total_time": total_time,
            "ave_time": total_time / (idx * n_chains), "n": idx}


def _read_best(ckpt_dir):
    """checkpoint/best.json ({'name', 'iter', 'epoch', 'metric', 'value'})."""
    path = os.path.join(ckpt_dir, "best.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_best_checkpoint(pipeline, ckpt_dir, epoch, step, metric_value, export_dir=None):
    """A rolling best-val snapshot ``best_I{it}_E{ep}`` beside the periodic
    checkpoints, tracked by ``best.json`` (the reference selects no best
    model). ``export_dir`` (``train.export_best``) also gets a compact
    ``best_params.npz`` and a copy of ``best.json``."""
    prev = _read_best(ckpt_dir)
    name = f"best_I{step}_E{epoch}"
    pipeline.ddpm.save_checkpoint(ckpt_dir, epoch, step, name=name)
    meta = {"name": name, "iter": step, "epoch": epoch, "metric": "MPSNR_cc",
            "value": metric_value}
    with open(os.path.join(ckpt_dir, "best.json"), "w") as f:
        json.dump(meta, f)
    if prev and prev.get("name") and prev["name"] != name:
        shutil.rmtree(os.path.join(ckpt_dir, prev["name"]), ignore_errors=True)
    if export_dir:
        pipeline.ddpm.export_params_npz(os.path.join(export_dir, "best_params.npz"))
        with open(os.path.join(export_dir, "best.json"), "w") as f:
            json.dump(meta, f)
    return name


def prune_periodic_checkpoints(ckpt_dir, keep):
    """Keep the newest ``keep`` periodic ``I{it}_E{ep}`` saves (by
    iteration), never touching ``best_*`` or ``best.json``. ``keep <= 0``
    keeps all (the reference's behaviour)."""
    if keep is None or keep <= 0:
        return
    pat = re.compile(r"^I(\d+)_E\d+$")
    found = []
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            found.append((int(m.group(1)), name))
    for _, name in sorted(found)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def train(opt, seed=0, max_steps=None, device=None):
    """The sr_gae train loop (sr_gae.py:210-424) on ``device`` (CUDA
    unless the caller asks for the CPU; raises without CUDA). Returns
    (pipeline, the last validation's results)."""
    dev = resolve_device(device)
    use_f32_policy()
    setup_logger("base", opt["path"]["log"], "train", screen=True)
    val_logger = setup_logger("val", opt["path"]["log"], "val")
    logger.info("validation writes .npy dumps only: the PNG dumps wait for a port of "
                "evalhsi/image_io.py")

    pipeline = build_pipeline(opt, seed=seed, device=dev)
    train_opt = opt["datasets"]["train"]
    val_opt = opt["datasets"]["val"]
    scale = opt.get("scale") or 4
    train_set = _limit(build_dataset(train_opt, "train", scale), train_opt.get("data_len"))
    val_set = _limit(build_dataset(val_opt, "val", scale), val_opt.get("data_len"))
    train_loader = DataLoader(train_set, batch_size=train_opt["batch_size"],
                              shuffle=bool(train_opt.get("use_shuffle", True)), seed=seed)
    val_loader = DataLoader(val_set, batch_size=1)

    n_iter = opt["train"]["n_iter"]
    if max_steps is not None:
        n_iter = min(n_iter, max_steps)
    print_freq = opt["train"]["print_freq"]
    val_freq = opt["train"]["val_freq"]
    save_freq = opt["train"]["save_checkpoint_freq"]
    per_group = bool(opt["train"].get("per_group_steps"))
    on_device_degr = bool(train_opt.get("on_device_degradation"))
    transfer_dtype = train_opt.get("transfer_dtype")  # e.g. "float16"

    # datasets.train.device_resident: the normalised scenes on the card,
    # crops sampled there; implies on-device degradation
    device_resident = bool(train_opt.get("device_resident"))
    scene_cache = None
    if device_resident:
        base_ds = getattr(train_set, "inner", train_set)
        scene_cache = DeviceSceneCache.from_dataset(
            base_ds, gt_size=(train_opt.get("l_resolution") or 32) * scale, device=dev)
        on_device_degr = True
        logger.info("device-resident sampling: %d scenes on %s, gt_size %d",
                    scene_cache.n_scenes, dev, scene_cache.gt_size)

    def _sampled_batches(start_step, n):
        """n on-device batches, each drawn from a generator seeded by the
        absolute step (stable across restarts)."""
        for j in range(n):
            gen = torch.Generator(device=dev).manual_seed(
                derive_seed(seed ^ 0x5CE9E5, start_step + 1 + j))
            yield {"HR": scene_cache.sample(gen, train_opt["batch_size"])}

    def _host_batches(loader):
        for batch in loader:
            if transfer_dtype:
                batch = {k: v.astype(transfer_dtype)
                         if isinstance(v, np.ndarray) and v.dtype == np.float32 else v
                         for k, v in batch.items()}
            yield batch

    current_step = pipeline.ddpm.begin_step
    current_epoch = pipeline.ddpm.begin_epoch
    if current_step:
        logger.info("resuming at iter %d (epoch %d)", current_step, current_epoch)
    ckpt_dir = opt["path"]["checkpoint"]
    prev_best = _read_best(ckpt_dir)
    best_val = prev_best["value"] if prev_best else -float("inf")
    results = {}
    steps_per_epoch = max(1, len(train_set) // train_opt["batch_size"])
    while current_step < n_iter:
        current_epoch += 1
        batches = (_sampled_batches(current_step, steps_per_epoch) if device_resident
                   else _host_batches(train_loader))
        for batch in batches:
            current_step += 1
            if current_step > n_iter:
                break
            if on_device_degr:
                loss = pipeline.train_step_from_hr(batch["HR"], scale=scale, per_group=per_group)
            else:
                loss = pipeline.train_step({"HR": batch["HR"], "SR": batch["SR"]},
                                           per_group=per_group)
            if current_step % print_freq == 0:
                logger.info("<epoch:%3d, iter:%8d> l_pix: %.4e", current_epoch, current_step,
                            float(loss))
            if current_step % save_freq == 0:
                # the periodic save comes BEFORE the val at the same step: a
                # failure during val then costs the val, not the progress
                pipeline.ddpm.save_checkpoint(ckpt_dir, current_epoch, current_step)
                prune_periodic_checkpoints(ckpt_dir,
                                           int(opt["train"].get("keep_checkpoints") or 3))
            if current_step % val_freq == 0:
                result_path = os.path.join(opt["path"]["results"], str(current_epoch))
                results = validate(pipeline, val_loader, opt, result_path, current_step,
                                   ratio=scale)
                val_logger.info(
                    "<epoch:%3d, iter:%8d> indices: %s indices_cc: %s chains: %d "
                    "mpsnr_cc_std: %.3f total_time: %.3f ave_time: %.3f",
                    current_epoch, current_step, results["indices"], results["indices_cc"],
                    results["n_chains"], results["mpsnr_cc_std"], results["total_time"],
                    results["ave_time"])
                val_psnr = results["indices_cc"]["MPSNR"]
                if val_psnr > best_val:
                    best_val = val_psnr
                    name = save_best_checkpoint(pipeline, ckpt_dir, current_epoch, current_step,
                                                val_psnr,
                                                export_dir=opt["train"].get("export_best"))
                    val_logger.info("new best MPSNR_cc %.3f -> saved %s", val_psnr, name)
    return pipeline, results


def run_val_phase(opt, seed=0, device=None):
    """The ``-p val`` evaluation (sr_gae.py:428-583). With no
    ``resume_state`` it evaluates the best-val snapshot named by
    ``checkpoint/best.json`` when there is one."""
    dev = resolve_device(device)
    use_f32_policy()
    setup_logger("base", opt["path"]["log"], "val", screen=True)
    logger.info("validation writes .npy dumps only: the PNG dumps wait for a port of "
                "evalhsi/image_io.py")
    if not opt["path"].get("resume_state"):
        best = _read_best(opt["path"]["checkpoint"])
        if best:
            opt["path"]["resume_state"] = os.path.join(opt["path"]["checkpoint"], best["name"])
            logger.info("no resume_state given; using best-val checkpoint %s "
                        "(MPSNR_cc %.3f at iter %d)", best["name"],
                        best.get("value", float("nan")), best.get("iter", -1))
    pipeline = build_pipeline(opt, seed=seed, device=dev)
    scale = opt.get("scale") or 4
    val_opt = opt["datasets"]["val"]
    val_set = _limit(build_dataset(val_opt, "val", scale), val_opt.get("data_len"))
    results = validate(pipeline, DataLoader(val_set, batch_size=1), opt,
                       os.path.join(opt["path"]["results"], "val"), 0, ratio=scale)
    logger.info("validation results: %s", results)
    return results
