"""Weight bridge: reference state_dicts and JAX param trees into the port.

The port's modules carry the reference's torch state_dict keys, so a
reference ``.pth`` state_dict loads as it is (``load_state_dict``). A
param tree of the JAX package (nested dicts of arrays, flax layout) loads
through ``load_jax_params``: each key of the module's state_dict is
mapped to its flax path by the port's own copy of the GAE and SR3 UNet
rules of ``hsi_dmgasr_tpu/io/convert_torch.py:torch_key_to_flax_path``,
and the array is brought back to torch layout (HWIO -> OIHW conv
kernels, (in, out) -> (out, in) linear kernels, GroupNorm ``scale`` ->
``weight``). ``export_jax_params`` is its inverse: a module's weights as
the flat flax-path dict of numpy arrays, in the JAX layouts.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_RULES = [
    (re.compile(r"^Encoder\."), "encoder/"),
    (re.compile(r"^Decoder\."), "decoder/"),
    # --- SR3 UNet (model/sr3_modules/unet.py)
    (re.compile(r"^denoise_fn\."), ""),  # GaussianDiffusion wrapper prefix
    (re.compile(r"^noise_level_mlp\.1\."), "noise_mlp_lin0/"),
    (re.compile(r"^noise_level_mlp\.3\."), "noise_mlp_lin1/"),
    (re.compile(r"^downs\.(\d+)\.conv\."), r"downs_\1_conv/"),  # Downsample
    (re.compile(r"^ups\.(\d+)\.conv\."), r"ups_\1_conv/"),  # Upsample
    (re.compile(r"^downs\.(\d+)\."), r"downs_\1/"),
    (re.compile(r"^ups\.(\d+)\."), r"ups_\1/"),
    (re.compile(r"^mid\.(\d+)\."), r"mid_\1/"),
    (re.compile(r"\bnoise_func\.noise_func\.0\."), "noise_func/func/"),
    (re.compile(r"\b(block1|block2|final_conv)\.block\.0\."), r"\1/norm/gn/"),
    (re.compile(r"\b(block1|block2|final_conv)\.block\.3\."), r"\1/conv/"),
    (re.compile(r"\battn\.norm\."), "attn/norm/gn/"),
    # --- GAE blocks (AE.py, common.py)
    (re.compile(r"\bnet\.(\d+)\."), r"net_\1/"),
    (re.compile(r"\bspa\.body\.0\."), "spa/conv0/"),
    (re.compile(r"\bspa\.body\.2\."), "spa/conv1/"),
    (re.compile(r"\bspc\.body\.0\."), "spc/conv0/"),
    (re.compile(r"\bspc\.body\.2\."), "spc/conv1/"),
    (re.compile(r"\bspc\.body\.3\.conv_du\.0\."), "spc/ca/conv_du0/"),
    (re.compile(r"\bspc\.body\.3\.conv_du\.2\."), "spc/ca/conv_du1/"),
    # Upsampler Sequential: convs sit at even indices (conv, shuffle, ...)
    (re.compile(r"\bupsample\.(\d+)\."),
     lambda m: f"upsample/conv_{int(m.group(1)) // 2}/"),
]


def torch_key_to_flax_path(key):
    """One torch state_dict key -> its flax param path tuple, e.g.
    ``Encoder.branch.body.net.0.spa.body.0.weight`` ->
    ``('encoder','branch','body','net_0','spa','conv0','kernel')``."""
    k = key
    for pat, rep in _RULES:
        k = pat.sub(rep, k)
    parts = k.replace(".", "/").split("/")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flax_path(key, like):
    path = torch_key_to_flax_path(key)
    if like.ndim == 1 and path[-1] == "kernel":
        path = path[:-1] + ("scale",)  # GroupNorm weight
    return path


def _to_torch_layout(arr, like):
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif arr.ndim == 2:
        arr = arr.T  # (in, out) -> (out, in)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape {arr.shape} vs module {tuple(like.shape)}")
    return torch.tensor(np.asarray(arr, dtype=np.float32))


def load_jax_params(module, flax_params):
    """Copy a JAX param tree (``{'params': tree}`` or the tree itself)
    into ``module``. Every module key must find its leaf and every leaf
    must be used; returns the module."""
    tree = flax_params.get("params", flax_params)
    flat = {path: np.asarray(v) for path, v in _flatten(tree)}
    sd = module.state_dict()
    used = set()
    new = {}
    for key, like in sd.items():
        path = _flax_path(key, like)
        if path not in flat:
            raise KeyError(f"{key}: no JAX param at {'/'.join(path)}")
        used.add(path)
        new[key] = _to_torch_layout(flat[path], like)
    unused = sorted("/".join(p) for p in set(flat) - used)
    if unused:
        raise KeyError(f"JAX params without a module key: {unused[:5]}")
    module.load_state_dict(new)
    return module


def export_jax_params(module):
    """``module``'s weights as ``{flax path tuple: f32 numpy array}``, the
    layouts of the JAX package (OIHW -> HWIO conv kernels, (out, in) ->
    (in, out) linear kernels, GroupNorm ``weight`` -> ``scale``): the
    inverse of ``load_jax_params``."""
    flat = {}
    for key, v in module.state_dict().items():
        arr = v.detach().float().cpu().numpy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif arr.ndim == 2:
            arr = arr.T  # (out, in) -> (in, out)
        flat[_flax_path(key, v)] = np.ascontiguousarray(arr)
    return flat


def unflatten(flat):
    """``{path tuple: array}`` -> nested dicts."""
    tree = {}
    for path, arr in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = arr
    return tree


def load_state_dict(module, state_dict, strict=True):
    """Load a reference-layout state_dict (tensors or arrays) as it is; a
    ``denoise_fn.`` prefix (diffusion checkpoints) is dropped.

    ``strict=False`` merges as the JAX package's ``load_torch_resume``
    does: the module keeps its own leaf wherever the state_dict has no
    key or a leaf of another shape, and keys the module lacks are
    ignored."""
    sd = {re.sub(r"^denoise_fn\.", "", k):
          v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
          for k, v in state_dict.items()}
    if not strict:
        own = module.state_dict()
        sd = {k: sd[k] if k in sd and tuple(sd[k].shape) == tuple(v.shape) else v
              for k, v in own.items()}
    module.load_state_dict(sd)
    return module


def unflatten_npz(path):
    """An ``export_params_npz`` file (flattened ``/`` keys, float16
    leaves) -> nested dicts of float32 arrays."""
    flat = {}
    with np.load(path) as z:
        for key in z.files:
            arr = z[key]
            if np.issubdtype(arr.dtype, np.floating):
                arr = arr.astype(np.float32)
            flat[tuple(key.split("/"))] = arr
    return unflatten(flat)
