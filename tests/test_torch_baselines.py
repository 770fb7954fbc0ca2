"""The port's baseline zoo (``hsi_dmgasr_tpu_torch/models/baselines``)
against the JAX package and the reference goldens.

Each model at the narrow widths of ``tests/test_baselines.py``: its
parameter count against ``baseline_params_golden.npz``; the reference
state_dict of its ``*_forward_golden.npz`` loaded strictly, reproducing
the golden ``y`` at the JAX tests' atol 2e-5, rtol 1e-4 (GDRRN 5e-5);
and a JAX param tree moved in through ``load_jax_params`` with the
model's rule group, the port's forward against the JAX forward on the
same seeded input at the same tolerance, and ``export_jax_params``
giving every leaf back. The tree is made by the JAX package's own
converter (``state_dict_to_flax``) from seeded weights (every leaf
random, so a weight norm's g is not |v| and the PReLU slopes and MCNet's
gamma are not their init) and checked against the paths and shapes of
the JAX module's init (``jax.eval_shape``: an eager init costs tens of
seconds on the CPU). The JAX converter has no rule for SSPSR's
``use_share=False`` groups (``branch.{g}``), so that tree is the port's
own export, still checked against the JAX init and forward.
"""

import os

import jax
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.io.convert_torch import state_dict_to_flax
from hsi_dmgasr_tpu.models import baselines as jb
from hsi_dmgasr_tpu.models.baselines import cegatsr as jcegatsr
from hsi_dmgasr_tpu_torch.io.convert_torch import (
    export_jax_params,
    load_jax_params,
    load_state_dict,
    unflatten,
)
from hsi_dmgasr_tpu_torch.models import baselines as pb
from hsi_dmgasr_tpu_torch.models.baselines import cegatsr as pcegatsr
from torch_port_weights import randomize

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
ATOL, RTOL = 2e-5, 1e-4
ATOL_GDRRN = 5e-5  # the JAX test's: 9 recursions of 128-wide convs


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


# name -> (JAX module, port module, rule group, the input: "x" (one
# input), "x,x" (SSPSR's lms = the LR cube) or "x,lms" (an HR-size lms))
def _models():
    return {
        "sspsr": (lambda: jb.SSPSR(n_subs=8, n_ovls=2, n_colors=31, n_blocks=3, n_feats=16,
                                   n_scale=4),
                  lambda: pb.SSPSR(8, 2, 31, n_blocks=3, n_feats=16, n_scale=4), None, "x,x"),
        "sspsr_unshared": (lambda: jb.SSPSR(n_subs=8, n_ovls=2, n_colors=31, n_blocks=1,
                                            n_feats=8, n_scale=4, use_share=False),
                           lambda: pb.SSPSR(8, 2, 31, n_blocks=1, n_feats=8, n_scale=4,
                                            use_share=False), None, "x,x"),
        "gelin": (lambda: jb.GELIN(n_feats=16, n_colors=31, n_subs=8, n_ovls=2, blocks=2, scale=4),
                  lambda: pb.GELIN(16, 31, n_subs=8, n_ovls=2, blocks=2, scale=4), None, "x,lms"),
        "gelin_x2": (lambda: jb.GELIN(n_feats=16, n_colors=31, n_subs=8, n_ovls=2, blocks=1,
                                      scale=2),
                     lambda: pb.GELIN(16, 31, n_subs=8, n_ovls=2, blocks=1, scale=2), None,
                     "x,lms"),
        "gelin_x8": (lambda: jb.GELIN(n_feats=16, n_colors=31, n_subs=8, n_ovls=2, blocks=1,
                                      scale=8),
                     lambda: pb.GELIN(16, 31, n_subs=8, n_ovls=2, blocks=1, scale=8), None,
                     "x,lms"),
        "mcnet": (lambda: jb.MCNet(scale=4, n_colors=31, n_feats=8),
                  lambda: pb.MCNet(4, 31, 8), "mcnet", "x"),
        "edsr": (lambda: jb.EDSR(n_resblocks=2, n_feats=16, n_colors=31),
                 lambda: pb.EDSR(2, 16, 31), "edsr", "x"),
        "gdrrn": (lambda: jb.GDRNN(input_chnl_hsi=31, group=4),
                  lambda: pb.GDRNN(31, 4), None, "x"),
        "cegatsr": (lambda: jb.CEGATSR(n_subs=8, n_ovls=2, in_feats=31, n_blocks=1, out_feats=16,
                                       n_scale=4),
                    lambda: pb.CEGATSR(8, 2, 31, n_blocks=1, out_feats=16, n_scale=4), "cegatsr",
                    "x,lms"),
    }


_SCALE = {"gelin_x2": 2, "gelin_x8": 8, "edsr": 2, "gdrrn": 1}


def _inputs(name, kind):
    x = _rand(1, 8, 8, 31, seed=3)
    if kind == "x":
        return (x,)
    if kind == "x,x":
        return x, x
    s = _SCALE.get(name, 4)
    return x, _rand(1, 8 * s, 8 * s, 31, seed=4)


@pytest.mark.parametrize("name", list(_models()))
def test_against_jax(name):
    jmod, pmod, group, kind = _models()[name]
    jm, pm = jmod(), pmod().eval()
    args = _inputs(name, kind)
    src = randomize(pmod(), seed=1)
    if name == "sspsr_unshared":  # the JAX converter has no rule for branch.{g}
        params = unflatten(export_jax_params(src))
    else:
        params = state_dict_to_flax({k: v.numpy() for k, v in src.state_dict().items()},
                                    model=group)["params"]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)["params"]
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda a: a.shape, shapes)
    want = np.asarray(jm.apply({"params": params}, *args))
    load_jax_params(pm, params, model=group)
    got = pm(*map(torch.from_numpy, args)).numpy()
    atol = ATOL_GDRRN if name == "gdrrn" else ATOL
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=RTOL)
    flat = _flat(params)
    back = export_jax_params(pm, model=group)
    assert back.keys() == flat.keys()
    for path, arr in flat.items():
        np.testing.assert_array_equal(back[path], arr, err_msg="/".join(path))


# golden file -> (port module at the golden's width, the input)
_GOLDENS = {
    "sspsr": (lambda: pb.SSPSR(8, 2, 31, n_blocks=3, n_feats=16, n_scale=4), "x,x"),
    "gelin": (lambda: pb.GELIN(16, 31, n_subs=8, n_ovls=2, blocks=2, scale=4), "x,lms"),
    "mcnet": (lambda: pb.MCNet(4, 31, 8), "x"),
    "edsr": (lambda: pb.EDSR(2, 16, 31), "x"),
    "gdrrn": (lambda: pb.GDRNN(31, 4), "x"),
    "cegatsr": (lambda: pb.CEGATSR(8, 2, 31, n_blocks=1, out_feats=16, n_scale=4), "x,lms"),
}


@pytest.mark.parametrize("name", list(_GOLDENS))
def test_reference_golden(name):
    """The reference state_dict loads strictly (CEGATSR's unused ``BN``
    included) and reproduces the reference forward."""
    g = np.load(os.path.join(GOLDEN, f"{name}_forward_golden.npz"))
    sd = {k.split("::", 1)[1]: g[k] for k in g.files if k.startswith("sd::")}
    make, kind = _GOLDENS[name]
    m = make().eval()
    assert m.state_dict().keys() == sd.keys()
    load_state_dict(m, sd)
    x = torch.from_numpy(np.moveaxis(g["x"], 1, -1))
    args = {"x": (x,), "x,x": (x, x),
            "x,lms": (x, torch.from_numpy(np.moveaxis(g["lms"], 1, -1)) if "lms" in g else x)}
    y = m(*args[kind]).numpy()
    np.testing.assert_allclose(np.moveaxis(y, -1, 1), g["y"],
                               atol=ATOL_GDRRN if name == "gdrrn" else ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["sspsr", "gelin", "mcnet", "edsr", "gdrrn"])
def test_param_count(name):
    """The reference's parameter count at the golden widths
    (``baseline_params_golden.npz``, as ``tests/test_baselines.py``)."""
    want = int(np.load(os.path.join(GOLDEN, "baseline_params_golden.npz"))[f"{name}_params"])
    assert sum(p.numel() for p in _GOLDENS[name][0]().parameters()) == want


def test_knn_adjacency_matches_jax():
    """The 7 nearest tokens, self included: the JAX set, 7 per row."""
    tokens = np.random.RandomState(5).randn(3, 64, 16).astype(np.float32)
    want = np.asarray(jcegatsr.knn_adjacency(tokens))
    got = pcegatsr.knn_adjacency(torch.from_numpy(tokens)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == 7).all() and (np.diagonal(got, axis1=1, axis2=2) == 1).all()


def test_cegatsr_bn_keeps_its_init_through_the_jax_bridge():
    """The JAX package drops the reference's unused ``branch.body.BN``;
    ``load_jax_params`` leaves it at the module's init and
    ``export_jax_params`` does not write it."""
    src = randomize(pb.CEGATSR(8, 2, 31, n_blocks=1, out_feats=16, n_scale=4), seed=2)
    params = state_dict_to_flax({k: v.numpy() for k, v in src.state_dict().items()},
                                model="cegatsr")["params"]
    pm = pb.CEGATSR(8, 2, 31, n_blocks=1, out_feats=16, n_scale=4)
    with torch.no_grad():
        pm.branch.body.BN.running_mean.fill_(0.5)
    load_jax_params(pm, params, model="cegatsr")
    assert (pm.branch.body.BN.running_mean == 0.5).all()
    assert not any("BN" in "/".join(p) for p in export_jax_params(pm, model="cegatsr"))


def test_cegatsr_train_mode_dropout_draws_from_its_generators():
    """In train mode the two GAT dropouts draw from their generators: the
    same seeds give the same output, another seed another one; eval mode
    is the identity."""
    m = pb.CEGATSR(8, 2, 31, n_blocks=1, out_feats=16, n_scale=4)
    x, lms = torch.from_numpy(_rand(1, 8, 8, 31)), torch.from_numpy(_rand(1, 32, 32, 31, seed=1))

    def run(seed):
        m.train()
        for i, d in enumerate((m.branch.head.body.drop_in, m.branch.head.body.drop_mid)):
            d.generator = torch.Generator().manual_seed(seed + i)
        return m(x, lms)

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(7))
    m.eval()
    assert torch.equal(m(x, lms), m(x, lms))
