"""Weight bridge: reference state_dicts and JAX param trees into the port.

The port's modules carry the reference's torch state_dict keys, so a
reference ``.pth`` state_dict loads as it is (``load_state_dict``). A
param tree of the JAX package (nested dicts of arrays, flax layout) loads
through ``load_jax_params``: each key of the module's state_dict is
mapped to its flax path by the port's own copy of the rules of
``hsi_dmgasr_tpu/io/convert_torch.py:torch_key_to_flax_path`` (the GAE,
SR3/DDPM UNet and GELIN rules, and the model-scoped groups of EDSR,
MCNet, the 3-D GAN's two nets and CEGATSR, taken by name), and the array
is brought back to torch layout (HWIO -> OIHW conv kernels, (in, out) ->
(out, in) linear kernels, norm ``scale`` -> ``weight``; only a leaf named
``kernel``, ``kernel_v`` or ``depth_kernel`` is laid out anew, so
CEGATSR's GAT ``W`` and ``a`` cross as they are). Keys of a module the
reference declares and never runs (CEGATSR's ``BN``) keep the module's
init, as the JAX package drops them. The layers of ``ops/extra.py`` take
their JAX leaves too: a transposed conv's (k..., in, out) kernel becomes
torch's (in, out, k...), a 3-D conv's (kd, kh, kw, in, out) torch's (out,
in, kd, kh, kw), a PReLU's ``alpha`` its ``weight``, and a weight-normed layer's
``kernel_v``/``kernel_g`` its ``weight_v``/``weight_g`` (g of shape (n,)
as (n, 1, ...)). A module with BatchNorm (the 'ddpm' UNet) reads its norms
under ``bn`` where the rules say ``gn``, and its running statistics from
the ``batch_stats`` collection (``mean``, ``var``), as the JAX package's
``state_dict_to_flax`` writes them. ``export_jax_params`` is the
inverse: a module's weights (or running statistics) as the flat
flax-path dict of numpy arrays, in the JAX layouts.

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
    (re.compile(r"^(noise_level_mlp|time_mlp)\.1\."), "noise_mlp_lin0/"),
    (re.compile(r"^(noise_level_mlp|time_mlp)\.3\."), "noise_mlp_lin1/"),
    (re.compile(r"^downs\.(\d+)\.conv\."), r"downs_\1_conv/"),  # Downsample
    (re.compile(r"^ups\.(\d+)\.conv\."), r"ups_\1_conv/"),  # Upsample
    (re.compile(r"^downs\.(\d+)\."), r"downs_\1/"),
    (re.compile(r"^ups\.(\d+)\."), r"ups_\1/"),
    (re.compile(r"^mid\.(\d+)\."), r"mid_\1/"),
    (re.compile(r"\bnoise_func\.noise_func\.0\."), "noise_func/func/"),
    (re.compile(r"\bmlp\.1\."), "noise_func/func/"),  # the ddpm variant's time head
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
    # --- SSPSR with use_share=False: one BranchUnit per group (SSPSR.py)
    (re.compile(r"^branch\.(\d+)\."), r"branch_\1/"),
    # --- GELIN (GELIN.py:100-276)
    (re.compile(r"^branch\.body\.(\d+)\.body\.0\."), r"branch/body_\1/sc/"),
    (re.compile(r"^branch\.body\.(\d+)\.body\.1\."), r"branch/body_\1/ca/"),
    (re.compile(r"\bsc/f1\.0\."), "sc/f1/"),
    (re.compile(r"\bsc/f2\.1\."), "sc/f2/"),
    (re.compile(r"\bsc/f4\.0\."), "sc/f4/"),
    (re.compile(r"\bca/body\.0\."), "ca/conv0/"),
    (re.compile(r"\bca/body\.2\."), "ca/conv1/"),
    (re.compile(r"\bca/conv_du\.1\."), "ca/du0/"),
    (re.compile(r"\bca/conv_du\.3\."), "ca/du1/"),
    (re.compile(r"\bTrunkUp\.0\."), "trunk_up/"),
    (re.compile(r"\bTrunkUp\.1\."), "trunk_act/"),
    (re.compile(r"\bMultiUp\.0\."), "multi0/"),
    (re.compile(r"\bMultiUp\.1\."), "multi1/"),
    (re.compile(r"\bMultiUp\.2\."), "multi_up/"),
    (re.compile(r"\bMultiUp\.3\."), "multi_act/"),
    (re.compile(r"\berror_resblock\.0\."), "error/"),
]

# model-scoped rule groups, applied before the common rules when a model is
# named (``load_jax_params(..., model=<name>)``): they keep generic names
# like ``tail.1`` of one model from another's paths
_MODEL_RULES = {
    # EDSR (GAE/EDSR.py:54-104); the Upsampler's convs at even indices
    "edsr": [
        (re.compile(r"^head\.0\."), "head/"),
        (re.compile(r"^body\.(\d+)\.body\.0\."), r"body_\1/conv0/"),
        (re.compile(r"^body\.(\d+)\.body\.2\."), r"body_\1/conv1/"),
        (re.compile(r"^body\.(\d+)\.(weight|bias)$"), r"body_tail/\2"),
        (re.compile(r"^tail\.0\.(\d+)\."),
         lambda m: f"upsample/conv_{int(m.group(1)) // 2}/"),
        (re.compile(r"^tail\.1\."), "tail/"),
    ],
    # MCNet (GAE/MCNet.py): weight-normed convs and module renames
    "mcnet": [
        (re.compile(r"^SSRM(\d)\."), lambda m: f"ssrm_{int(m.group(1)) - 1}/"),
        (re.compile(r"\bBlock(\d)\.(\d+)\.conv\.(\d+)\.conv\."),
         lambda m: f"block{m.group(1)}_{m.group(2)}/c{m.group(3)}/"),
        (re.compile(r"\bConv\.conv\.(\d+)\.conv\."), lambda m: f"conv_out/c{m.group(1)}/"),
        (re.compile(r"\breduceF\.conv\."), "reduceF/"),
        (re.compile(r"\bconv([123])\.0\."), r"conv\1/c0/"),
        (re.compile(r"\bconv([123])\.2\."), r"conv\1/c1/"),
        (re.compile(r"^tail\.0\."), "tail_up/"),
        (re.compile(r"^tail\.1\."), "tail_conv/"),
    ],
    # the 3-D GAN's generator (GAE/net.py:75-131)
    "gan3d_g": [
        (re.compile(r"^conv_1\.0\."), "conv1/"),
        (re.compile(r"^attn_(\d)\.conv_1\.0\."), r"attn\1/conv1a/"),
        (re.compile(r"^attn_(\d)\.conv_1\.2\."), r"attn\1/conv1b/"),
        (re.compile(r"^attn_(\d)\.conv_2\.0\."), r"attn\1/fc0/"),
        (re.compile(r"^attn_(\d)\.conv_2\.2\."), r"attn\1/fc1/"),
        (re.compile(r"^conv_2\.0\."), "conv2/"),
        (re.compile(r"^conv_3\."), "conv3/"),
        (re.compile(r"^conv_4\.0\."), "conv4/"),
        (re.compile(r"^conv_5\."), "conv5/"),
    ],
    # the 3-D GAN's discriminator (GAE/net.py:134-185): Sequential index ->
    # conv/BatchNorm names (pads and activations hold the other indices)
    "gan3d_d": [
        (re.compile(rf"^conv\.{i}\."), f"{name}/")
        for i, name in ((0, "c1"), (3, "c2"), (4, "b2"), (6, "c3"), (7, "b3"), (10, "c4"),
                        (11, "b4"), (13, "c5"), (14, "b5"), (16, "c6"), (17, "b6"))
    ] + [
        (re.compile(r"^linera\.0\."), "fc0/"),
        (re.compile(r"^linera\.2\."), "fc1/"),
    ],
    # CEGATSR (GAE/CEGATSR.py)
    "cegatsr": [
        (re.compile(r"^branch\.head\.head\.head\."), "branch/head/head/"),
        (re.compile(r"^branch\.head\.last\.last\."), "branch/head/last/"),
        (re.compile(r"^branch\.head\.body\."), "branch/head/body/"),
        (re.compile(r"\bdepth_conv\.weight$"), "depth_kernel"),
        (re.compile(r"\bdepth_conv\.bias$"), "depth_bias"),
        (re.compile(r"^trunk\.head\."), "trunk_head/"),
        (re.compile(r"^trunk\.body\."), "trunk_body/"),
        (re.compile(r"^trunk\.upsample\.(\d+)\."),
         lambda m: f"trunk_up/conv_{int(m.group(1)) // 2}/"),
    ],
}

# keys of modules the reference declares and its forward never runs
# (CEGATSR's CNNUnit.BN): the JAX package has no leaf for them, so
# ``load_jax_params`` leaves them at the module's init
_DROP_KEYS = re.compile(r"\bBN\.(weight|bias|running_mean|running_var|num_batches_tracked)$")


def torch_key_to_flax_path(key, model=None):
    """One torch state_dict key -> its flax param path tuple, e.g.
    ``Encoder.branch.body.net.0.spa.body.0.weight`` ->
    ``('encoder','branch','body','net_0','spa','conv0','kernel')``.
    ``model`` names a rule group of ``_MODEL_RULES``, applied first."""
    k = key
    for pat, rep in _MODEL_RULES.get(model, []) + _RULES:
        k = pat.sub(rep, k)
    parts = k.replace(".", "/").split("/")
    parts[-1] = {"weight": "kernel", "weight_v": "kernel_v",
                 "weight_g": "kernel_g"}.get(parts[-1], parts[-1])
    return tuple(parts)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


_STATS = {"running_mean": "mean", "running_var": "var"}


def _has_bn(state_dict):
    """Whether a state_dict holds BatchNorm statistics outside the dropped
    keys (the JAX package's ``has_bn``: then every norm is under ``bn``,
    not ``gn``)."""
    return any(k.endswith("running_mean") and not _DROP_KEYS.search(k) for k in state_dict)


def _layer_kinds(module):
    """state_dict key prefix -> "deconv" or "prelu" for the layers whose
    leaves the JAX package lays out or names otherwise."""
    kinds = {}
    for name, m in module.named_modules():
        if isinstance(m, (torch.nn.ConvTranspose2d, torch.nn.ConvTranspose3d)):
            kinds[name] = "deconv"
        elif isinstance(m, torch.nn.PReLU):
            kinds[name] = "prelu"
    return kinds


def _kind(key, kinds):
    return kinds.get(key.rpartition(".")[0])


def _jax_leaf(key, like, bn, kind=None, model=None):
    """(collection, flax path) of one state_dict key; None for
    ``num_batches_tracked`` and the dropped keys, which the JAX package
    does not keep."""
    if key.endswith("num_batches_tracked") or _DROP_KEYS.search(key):
        return None
    path = torch_key_to_flax_path(key, model)
    if bn:
        path = tuple("bn" if p == "gn" else p for p in path)
    if path[-1] in _STATS:
        return "batch_stats", path[:-1] + (_STATS[path[-1]],)
    if like.ndim == 1 and path[-1] == "kernel":
        # a PReLU's slope, else a norm's weight
        path = path[:-1] + ("alpha" if kind == "prelu" else "scale",)
    return "params", path


def _jax_to_torch_axes(ndim, kind):
    """The permutation taking a JAX kernel of ``ndim`` axes (spatial...,
    in, out) to torch's layout: (out, in, spatial...), or (in, out,
    spatial...) for a transposed conv."""
    io = (ndim - 2, ndim - 1) if kind == "deconv" else (ndim - 1, ndim - 2)
    return io + tuple(range(ndim - 2))


# the leaves whose layout differs between the packages: conv kernels (and a
# weight norm's direction, CEGATSR's depthwise kernel) and linear kernels.
# Any other leaf (CEGATSR's GAT ``W`` (in, out) and ``a`` (2F, 1)) crosses
# as it is.
_KERNELS = ("kernel", "kernel_v", "depth_kernel")


def _to_torch_layout(arr, like, leaf, kind=None):
    if arr.ndim >= 4 and leaf in _KERNELS:
        arr = arr.transpose(_jax_to_torch_axes(arr.ndim, kind))
    elif arr.ndim == 2 and leaf == "kernel":
        arr = arr.T  # (in, out) -> (out, in)
    elif arr.ndim == 1 and like.ndim > 1:
        arr = arr.reshape(like.shape)  # a weight norm's g: (n,) -> (n, 1, ...)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"shape {arr.shape} vs module {tuple(like.shape)}")
    return torch.tensor(np.asarray(arr, dtype=np.float32))


def load_jax_params(module, flax_params, model=None):
    """Copy a JAX variable tree (``{'params': tree[, 'batch_stats': tree]}``
    or the params tree itself) into ``module``, the keys mapped with the
    rule group ``model`` of ``_MODEL_RULES`` (``"edsr"``, ``"mcnet"``,
    ``"gan3d_g"``, ``"gan3d_d"``, ``"cegatsr"``) when given. Every module
    key must find its leaf and every leaf must be used
    (``num_batches_tracked`` and the dropped keys keep the module's value);
    returns the module."""
    trees = ({c: flax_params[c] for c in ("params", "batch_stats") if c in flax_params}
             if "params" in flax_params else {"params": flax_params})
    flat = {(c,) + path: np.asarray(v) for c, tree in trees.items()
            for path, v in _flatten(tree)}
    sd = module.state_dict()
    bn = _has_bn(sd)
    kinds = _layer_kinds(module)
    used = set()
    new = {}
    for key, like in sd.items():
        leaf = _jax_leaf(key, like, bn, _kind(key, kinds), model)
        if leaf is None:
            new[key] = like
            continue
        path = (leaf[0],) + leaf[1]
        if path not in flat:
            raise KeyError(f"{key}: no JAX {leaf[0]} at {'/'.join(leaf[1])}")
        used.add(path)
        new[key] = _to_torch_layout(flat[path], like, path[-1], _kind(key, kinds))
    unused = sorted("/".join(p) for p in set(flat) - used)
    if unused:
        raise KeyError(f"JAX params without a module key: {unused[:5]}")
    module.load_state_dict(new)
    return module


def export_jax_params(module, collection="params", model=None):
    """``module``'s weights (``collection="params"``) or BatchNorm running
    statistics (``"batch_stats"``) as ``{flax path tuple: f32 numpy
    array}``, the layouts of the JAX package (OIHW -> HWIO conv kernels,
    (out, in) -> (in, out) linear kernels, norm ``weight`` -> ``scale``),
    the paths mapped with the rule group ``model``: the inverse of
    ``load_jax_params``."""
    sd = module.state_dict()
    bn = _has_bn(sd)
    kinds = _layer_kinds(module)
    flat = {}
    for key, v in sd.items():
        kind = _kind(key, kinds)
        leaf = _jax_leaf(key, v, bn, kind, model)
        if leaf is None or leaf[0] != collection:
            continue
        arr = v.detach().float().cpu().numpy()
        name = leaf[1][-1]
        if name == "kernel_g":
            arr = arr.reshape(-1)
        elif arr.ndim >= 4 and name in _KERNELS:
            arr = arr.transpose(np.argsort(_jax_to_torch_axes(arr.ndim, kind)))
        elif arr.ndim == 2 and name == "kernel":
            arr = arr.T  # (out, in) -> (in, out)
        flat[leaf[1]] = np.ascontiguousarray(arr)
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
