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

The shipped GAE checkpoints are whole-module pickles: ``load_torch_gae``
reads them through stub classes (a copy of the JAX module's unpickler),
and ``read_state_dict`` reads either kind of ``.pth``.
"""

from __future__ import annotations

import re
import types

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


# ---------------------------------------------------------------------------
# whole-module pickles: the shipped GAE checkpoints (``torch.save(AE_model)``,
# reference AE.py:637) name their classes ``__main__.{GAE, Encoder, ...}`` and
# ``common.{ResBlock, ...}``. Unpickling an nn.Module restores only instance
# ``__dict__``s, so empty stand-in classes under those names read them without
# running any reference code; torch's own layers inside resolve to torch.

_MAIN_CLASSES = ("GAE", "Encoder", "Decoder", "BranchUnit", "SSB", "SSPN",
                 "AE", "AE_duichen", "SR_encoder", "post_GAE", "Autoencoder",
                 "Swish", "Codebook")
_COMMON_CLASSES = ("ResBlock", "ResAttentionBlock", "CALayer", "Upsampler",
                   "BasicBlock", "MeanShift", "GroupNorm", "Swish")

_STUB_MODULES = {
    "__main__": _MAIN_CLASSES,
    "common": _COMMON_CLASSES,
    "quantize": ("Quantization", "Conv2d_Q"),
    "GELIN": ("GELIN", "SSELM", "NGIM", "HLoss"),
}

_stub_cache = {}


def stub_class(module, name):
    """The empty ``nn.Module`` subclass standing in for reference class
    ``module.name`` (one class per name, made at first use)."""
    key = (module, name)
    if key not in _stub_cache:
        _stub_cache[key] = type(name, (torch.nn.Module,), {"__module__": module})
    return _stub_cache[key]


def _stub_pickle_module():
    """A pickle module whose Unpickler resolves the reference's class paths
    to stubs, without touching ``sys.modules`` or ``__main__`` (a caller's
    own ``GAE`` or ``Encoder`` is never shadowed or used)."""
    import pickle

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if name in _STUB_MODULES.get(module, ()):
                return stub_class(module, name)
            return super().find_class(module, name)

    shim = types.ModuleType("hsi_dmgasr_tpu_torch_stub_pickle")
    shim.Unpickler = StubUnpickler
    shim.load = pickle.load
    shim.loads = pickle.loads
    shim.dumps = pickle.dumps
    shim.HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
    return shim


def load_torch_module(path):
    """Unpickle a whole-module (or state_dict) ``.pth`` on the CPU through
    the stub classes. This runs the pickle: read only files you trust."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_stub_pickle_module())


def read_state_dict(path):
    """A ``.pth`` holding a state_dict or a whole module -> its state_dict
    (CPU tensors)."""
    obj = load_torch_module(path)
    if isinstance(obj, torch.nn.Module):
        obj = obj.state_dict()
    return {k: torch.as_tensor(v).detach() for k, v in obj.items()}


def gae_config_from_module(mod):
    """(n_subs, n_ovls, n_colors, n_feats, G, start_idx, end_idx) of an
    unpickled reference GAE: ``start_idx``/``end_idx`` are plain attributes
    restored by pickle (AE.py:266-280), n_feats is the encoder head's
    output width."""
    start = list(mod.start_idx)
    end = list(mod.end_idx)
    n_subs = end[0] - start[0]
    n_ovls = n_subs - (start[1] - start[0]) if len(start) > 1 else 0
    return dict(n_subs=n_subs, n_ovls=n_ovls, n_colors=end[-1],
                n_feats=mod.Encoder.branch.head.weight.shape[0], G=len(start),
                start_idx=start, end_idx=end)


def load_torch_gae(path):
    """A shipped whole-module GAE ``.pth`` -> (state_dict, config). The port's
    GAE keeps the reference's keys, so the state_dict loads into
    ``models.gae.GAE`` built with the config's n_subs, n_ovls, n_colors and
    n_feats."""
    mod = load_torch_module(path)
    if not hasattr(mod, "start_idx"):
        raise ValueError(f"{path}: not a reference GAE module (it has no start_idx)")
    cfg = gae_config_from_module(mod)
    return {k: v.detach() for k, v in mod.state_dict().items()}, cfg


def load_torch_vgg19(path):
    """A user-supplied torchvision ``vgg19*.pth`` (state_dict or whole
    module) -> a state_dict for ``models.vgg.VGG19``."""
    return read_state_dict(path)
