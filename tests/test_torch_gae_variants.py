"""The port's GAE variants and ``ops/extra.py`` against the JAX package.

The cases of ``tests/test_gae_variants.py`` and ``test_prelu_and_avgpool``
of ``tests/test_extras.py`` on the port, then each variant and each layer
of ``ops/extra.py`` on JAX parameters (the JAX package's init, or seeded
weights through its converter), moved in through
``io/convert_torch.py:load_jax_params``, against the JAX forward on the
same input. Tolerance 1e-5: f32 convolutions summed
in another order. A transposed conv's layout and spatial flip are held
against torch's own ``conv_transpose2d`` on the loaded weight as well,
and ``export_jax_params`` gives every JAX leaf back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hsi_dmgasr_tpu.models import gae as jgae
from hsi_dmgasr_tpu.ops import extra as jextra
from hsi_dmgasr_tpu_torch.io.convert_torch import export_jax_params, load_jax_params
from hsi_dmgasr_tpu_torch.models import gae
from hsi_dmgasr_tpu_torch.ops import extra
from torch_port_weights import jax_variables, randomize

TOL = 1e-5


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


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL)


# ------------------------------------------- tests/test_gae_variants.py


def test_gae_trunkless_is_plain_overlap_average():
    """use_trunk=False == AE_duichen (AE.py:433-513): no trunk or final,
    decode is the bare overlap average of the decoder's outputs."""
    m = gae.GAE(n_subs=8, n_ovls=2, n_colors=31, n_feats=8, use_trunk=False)
    assert not any(k.startswith(("trunk.", "final.")) for k in m.state_dict())
    x = torch.from_numpy(_rand(1, 16, 16, 31))
    recon, z = m(x)
    assert recon.shape == x.shape
    z0 = torch.zeros_like(z)
    y0 = m.decode(z0)
    dec0 = m.Decoder(z0.reshape(-1, 16, 16, 3))
    # band 1 is covered by the first group alone
    np.testing.assert_allclose(y0[0, :, :, 1].numpy(), dec0[0, :, :, 1].numpy(), atol=1e-6)


def test_ungrouped_ae_roundtrip():
    m = gae.AE(in_channels=31, n_feats=8)
    recon, z = m(torch.from_numpy(_rand(1, 16, 16, 31)))
    assert recon.shape == (1, 16, 16, 31) and z.shape == (1, 16, 16, 3)


def test_sr_encoder_only():
    m = gae.SREncoder(n_subs=8, n_ovls=2, n_colors=31, n_feats=8)
    assert m(torch.from_numpy(_rand(1, 16, 16, 31))).shape == (1, 5, 16, 16, 3)


def test_post_gae_and_toy_ae():
    x = torch.from_numpy(_rand(1, 16, 16, 31))
    assert gae.PostGAE(n_colors=31)(x).shape == x.shape
    xt = torch.from_numpy(_rand(1, 16, 16, 33, seed=1))
    y, z = gae.ToyAutoencoder(in_channels=33)(xt)
    assert y.shape == xt.shape and z.shape == (1, 4, 4, 3)


def test_random_mask_fraction():
    """The JAX package's call, random_mask(key, data, p), with the port's
    generator in the key's place."""
    def jax_order(key, data, p):
        return gae.random_mask(data, p, generator=key)

    m = jax_order(torch.Generator().manual_seed(0), torch.ones(64, 64), p=0.3)
    assert 0.2 < float((m == 0).float().mean()) < 0.4
    a = jax_order(torch.Generator().manual_seed(1), torch.ones(8, 8), 0.5)
    b = gae.random_mask(torch.ones(8, 8), 0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)


# ---------------------------------------- the variants against the JAX package


VARIANTS = {
    "gae_trunkless": (lambda: jgae.GAE(n_subs=8, n_ovls=2, n_colors=31, n_feats=8,
                                       use_trunk=False),
                      lambda: gae.GAE(n_subs=8, n_ovls=2, n_colors=31, n_feats=8,
                                      use_trunk=False), 31),
    "ae": (lambda: jgae.AE(in_channels=31, n_feats=8),
           lambda: gae.AE(in_channels=31, n_feats=8), 31),
    "sr_encoder": (lambda: jgae.SREncoder(n_subs=8, n_ovls=2, n_colors=31, n_feats=8),
                   lambda: gae.SREncoder(n_subs=8, n_ovls=2, n_colors=31, n_feats=8), 31),
    "post_gae": (lambda: jgae.PostGAE(n_colors=31), lambda: gae.PostGAE(n_colors=31), 31),
    "toy": (lambda: jgae.ToyAutoencoder(in_channels=33),
            lambda: gae.ToyAutoencoder(in_channels=33), 33),
}


def _variables(name, jm, x):
    """The JAX module's variables: seeded port weights through the JAX
    package's converter (checked against its init's tree), or for the toy,
    whose transposed convs that converter does not know by name, its init
    (an eager JAX init compiles op by op: tens of seconds for a GAE)."""
    if name == "toy":
        return jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    return jax_variables(jm, randomize(VARIANTS[name][1](), 4), x)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forward_matches_jax(name):
    jcls, tcls, c = VARIANTS[name]
    x = _rand(2, 16, 16, c, seed=3)
    jm = jcls()
    v = _variables(name, jm, x)
    want = jax.jit(jm.apply)(v, x)
    tm = load_jax_params(tcls(), v)
    got = tm(torch.from_numpy(x))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)
    exported = export_jax_params(tm)
    for path, arr in _flat(v["params"]).items():
        np.testing.assert_array_equal(exported[path], arr)


# -------------------------------------------------- ops/extra.py against JAX


def test_prelu_and_avgpool():
    x = np.random.RandomState(0).randn(1, 8, 8, 4).astype(np.float32)
    out = extra.PReLU(4)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.where(x > 0, x, 0.25 * x), atol=1e-6)
    pooled = extra.avg_pool(torch.from_numpy(x), 2).numpy()
    assert pooled.shape == (1, 4, 4, 4)
    np.testing.assert_allclose(pooled[0, 0, 0], x[0, :2, :2].mean(axis=(0, 1)), rtol=1e-5)


def _layer_pair(jm, tm, x):
    """JAX init on x, its parameters into the port layer, both forwards."""
    v = jm.init(jax.random.PRNGKey(1), x)
    load_jax_params(tm, v)
    return tm(torch.from_numpy(x)), jm.apply(v, x), v


def test_prelu_matches_jax():
    x = np.random.RandomState(1).randn(2, 6, 6, 4).astype(np.float32)
    jm = jextra.PReLU(4)
    v = jax.tree.map(lambda a: a + jnp.arange(4, dtype=a.dtype) * 0.1,
                     jm.init(jax.random.PRNGKey(0), x))
    tm = load_jax_params(extra.PReLU(4), v)
    _close(tm(torch.from_numpy(x)), jm.apply(v, x))


@pytest.mark.parametrize("k,s,p,op", [(3, 1, 1, 0), (3, 2, 1, 1), (4, 2, 1, 0), (6, 4, 1, 0)])
def test_deconv2d_matches_jax_and_torch(k, s, p, op):
    x = np.random.RandomState(2).randn(2, 5, 6, 3).astype(np.float32)
    tm = extra.Deconv2d(3, 7, k, s, p, output_padding=op)
    got, want, _ = _layer_pair(jextra.Deconv2d(7, k, s, p, output_padding=op), tm, x)
    assert got.shape == ((2, (5 - 1) * s - 2 * p + k + op, (6 - 1) * s - 2 * p + k + op, 7))
    _close(got, want)
    native = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2), tm.weight, tm.bias,
                                s, p, op).permute(0, 2, 3, 1)
    _close(got, native)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_conv3d_matches_jax(weight_norm):
    x = np.random.RandomState(3).randn(2, 5, 6, 7, 3).astype(np.float32)
    tm = extra.Conv3d(3, 4, (3, 1, 3), weight_norm=weight_norm)
    got, want, v = _layer_pair(jextra.Conv3d(4, (3, 1, 3), weight_norm=weight_norm), tm, x)
    _close(got, want)
    assert sorted(tm.state_dict()) == (["bias", "weight_g", "weight_v"] if weight_norm
                                       else ["bias", "weight"])
    for path, arr in _flat(v["params"]).items():
        np.testing.assert_array_equal(export_jax_params(tm)[path], arr)


@pytest.mark.parametrize("weight_norm", [False, True])
def test_deconv3d_matches_jax(weight_norm):
    x = np.random.RandomState(4).randn(2, 5, 6, 7, 3).astype(np.float32)
    args = ((3, 4, 4), (1, 2, 2), (1, 1, 1))
    tm = extra.Deconv3d(3, 4, *args, weight_norm=weight_norm)
    got, want, _ = _layer_pair(jextra.Deconv3d(4, *args, weight_norm=weight_norm), tm, x)
    assert got.shape == (2, 5, 12, 14, 4)
    _close(got, want)


def test_weight_norm_is_over_torchs_dim_0():
    """g v / |v| with |v| over every axis but torch's dim 0: the output
    channel of a conv, the input channel of a transposed conv."""
    for layer in (extra.Conv3d(3, 4, (3, 3, 3), weight_norm=True),
                  extra.Deconv3d(3, 4, (3, 4, 4), (1, 2, 2), (1, 1, 1), weight_norm=True)):
        w = extra._weight(layer)
        norms = w.pow(2).sum(tuple(range(1, w.ndim))).sqrt()
        assert layer.weight_g.shape == (w.shape[0], 1, 1, 1, 1)
        np.testing.assert_allclose(norms.numpy(), layer.weight_g.reshape(-1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("window,stride", [(2, None), (3, 1), (4, 2)])
def test_avg_pool_matches_jax(window, stride):
    x = np.random.RandomState(5).randn(2, 9, 8, 3).astype(np.float32)
    _close(extra.avg_pool(torch.from_numpy(x), window, stride),
           jextra.avg_pool(jnp.asarray(x), window, stride))


@pytest.mark.parametrize("out_hw", [(16, 16), (3, 5), (5, 3), (12, 20)])
def test_resize_nearest_matches_jax(out_hw):
    x = np.random.RandomState(6).randn(1, 8, 8, 4).astype(np.float32)
    _close(extra.resize_nearest(torch.from_numpy(x), out_hw),
           jextra.resize_nearest(jnp.asarray(x), out_hw))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(16, 16), (5, 12), (32, 24)])
def test_torch_bicubic_matches_jax_and_interpolate(align_corners, out_hw):
    x = np.random.RandomState(7).rand(2, 8, 8, 3).astype(np.float32)
    got = extra.make_torch_bicubic((8, 8), out_hw, align_corners,
                                   device="cpu")(torch.from_numpy(x))
    _close(got, jextra.make_torch_bicubic_jax((8, 8), out_hw, align_corners)(jnp.asarray(x)))
    ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw, mode="bicubic",
                        align_corners=align_corners).permute(0, 2, 3, 1)
    _close(got, ref)
