"""Config system: JSON with ``//`` comments, NoneDict semantics, debug mode.

Port of ``hsi_dmgasr_tpu/config.py`` (reference ``core/logger.py:21-141``):

  * JSON configs may carry ``//`` line comments (stripped per line).
  * ``parse`` creates the experiment directory tree
    ``experiments/{name}_{timestamp}/{log,tb_logger,results,checkpoint}``
    (or under ``experiments_root``).
  * ``debug`` rewrites the config into a miniature end-to-end run
    (val_freq=2, n_timestep=10, data_len=6/3, batch_size=2).
  * Missing keys read as ``None`` (NoneDict).

The port runs on one card: ``gpu_ids`` is kept for the schema only, and
the W&B flags of the JAX package are not ported.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict
from datetime import datetime


class NoneDict(dict):
    """dict returning None for missing keys (core/logger.py:97-100)."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    """Recursively convert dicts to NoneDict (core/logger.py:103-112)."""
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def load_json_with_comments(path):
    """Load a JSON file stripping ``//`` line comments (core/logger.py:27-32)."""
    with open(path, "r") as f:
        json_str = "".join(line.split("//")[0] + "\n" for line in f)
    return json.loads(json_str, object_pairs_hook=OrderedDict)


def load(path):
    """A config file as a NoneDict tree."""
    return dict_to_nonedict(load_json_with_comments(path))


def get_timestamp():
    return datetime.now().strftime("%y%m%d_%H%M%S")


def apply_debug(opt):
    """Miniaturize a config for smoke runs (core/logger.py:61-70)."""
    opt["train"]["val_freq"] = 2
    opt["train"]["print_freq"] = 2
    opt["train"]["save_checkpoint_freq"] = 3
    opt["datasets"]["train"]["batch_size"] = 2
    opt["model"]["beta_schedule"]["train"]["n_timestep"] = 10
    opt["model"]["beta_schedule"]["val"]["n_timestep"] = 10
    opt["datasets"]["train"]["data_len"] = 6
    opt["datasets"]["val"]["data_len"] = 3
    return opt


def parse(config, phase="train", experiments_root=None, debug=False):
    """A config file (or a dict) as an option NoneDict, with its
    experiment directories made (``Logger.parse``, core/logger.py:21-94)."""
    opt = (load_json_with_comments(config) if isinstance(config, (str, os.PathLike))
           else json.loads(json.dumps(config), object_pairs_hook=OrderedDict))
    if debug:
        opt["name"] = "debug_{}".format(opt["name"])
    if experiments_root is None:
        experiments_root = os.path.join("experiments", "{}_{}".format(opt["name"],
                                                                     get_timestamp()))
    opt.setdefault("path", OrderedDict())
    opt["path"]["experiments_root"] = experiments_root
    for key, path in list(opt["path"].items()):
        if "resume" not in key and "experiments" not in key:
            opt["path"][key] = os.path.join(experiments_root, path)
            os.makedirs(opt["path"][key], exist_ok=True)
    opt["phase"] = phase
    if "debug" in opt["name"]:
        apply_debug(opt)
    if phase == "train" and opt.get("datasets", {}).get("val") is not None:
        opt["datasets"]["val"]["data_len"] = 3
    return dict_to_nonedict(opt)


def setup_logger(logger_name, root, phase, level=logging.INFO, screen=False):
    """File (appended: a resumed run keeps its curve) and optional screen
    handlers on a named logger (core/logger.py:128-141), in place of the
    handlers an earlier call gave it."""
    lg = logging.getLogger(logger_name)
    for h in list(lg.handlers):
        lg.removeHandler(h)
        h.close()
    formatter = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                                  datefmt="%y-%m-%d %H:%M:%S")
    fh = logging.FileHandler(os.path.join(root, "{}.log".format(phase)), mode="a")
    fh.setFormatter(formatter)
    lg.setLevel(level)
    lg.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        lg.addHandler(sh)
    return lg
