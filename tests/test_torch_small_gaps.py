"""Small pieces of the port against the JAX package: ``DDPMModel``'s
``get_current_log`` and ``n_params``, and the thin Block
(``kernels/fused_conv.py:gn_swish_conv3x3_thin``, plain torch, the port of
the JAX function), held to the JAX ``gn_swish_conv3x3_thin`` within 1e-5
(atol and rtol, f32), with and without chained moments, and its H-shard
form (halo rows, the whole image's moments) to its whole-image form
within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.kernels import fused_conv as jfc
from hsi_dmgasr_tpu_torch.kernels import fused_conv as pfc
from hsi_dmgasr_tpu_torch.parallel.mesh import Mesh
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel
from test_torch_train import _batch, _opt

TOL = 1e-5


def _thin_inputs(seed=0, b=2, h=8, w=10, c=16, cout=3):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(b, h, w, c).astype(np.float32),
                gn_scale=(rng.rand(c) + 0.5).astype(np.float32),
                gn_bias=(0.1 * rng.randn(c)).astype(np.float32),
                kernel=(rng.randn(3, 3, c, cout) / np.sqrt(9 * c)).astype(np.float32),
                bias=(0.1 * rng.randn(cout)).astype(np.float32))


@pytest.mark.parametrize("chained", [False, True])
def test_thin_block_matches_jax(chained):
    d = _thin_inputs()
    stats = np.stack([d["x"].sum(2), (d["x"] ** 2).sum(2)], 2) if chained else None
    want = jfc.gn_swish_conv3x3_thin(*(jnp.asarray(v) for v in d.values()),
                                     stats_in=None if stats is None else jnp.asarray(stats),
                                     num_groups=4)
    got = pfc.gn_swish_conv3x3_thin(*(torch.tensor(v) for v in d.values()),
                                    stats_in=None if stats is None else torch.tensor(stats),
                                    num_groups=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_thin_block_h_shards(monkeypatch):
    """Each of two H-shards with its neighbour's rows as halo (edges
    zeroed by the mesh's flags) and the whole image's per-row moments."""
    d = {k: torch.tensor(v) for k, v in _thin_inputs(1).items()}
    x = d.pop("x")
    whole = pfc.gn_swish_conv3x3_thin(x, *d.values(), num_groups=4)
    rows = pfc._row_moments(x)
    monkeypatch.setattr(pfc, "gather_rows", lambda st, mesh, kind: rows)
    parts = []
    for i, (lo, hi) in enumerate(((0, 4), (4, 8))):
        mesh = Mesh(1, 2, 0, i, torch.device("cpu"))
        halo = (x[:, max(lo - 1, 0):max(lo - 1, 0) + 1], x[:, min(hi, 7):min(hi, 7) + 1])
        parts.append(pfc.gn_swish_conv3x3_thin(x[:, lo:hi], *d.values(), num_groups=4,
                                               mesh=mesh, halo=halo))
    torch.testing.assert_close(torch.cat(parts, 1), whole, atol=1e-6, rtol=1e-6)


def test_current_log_and_n_params():
    opt = _opt(ema=False)
    model = DDPMModel(opt, device="cpu")
    assert model.get_current_log() == {}
    assert model.n_params == sum(p.numel() for p in model.unet.parameters()) > 0
    from hsi_dmgasr_tpu.models.unet import UNet as JUNet
    import jax

    jvars = jax.eval_shape(JUNet(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4,
                                 channel_mults=(1, 2), attn_res=(8,), res_blocks=1,
                                 image_size=16).init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 16, 16, 6)), jnp.zeros((1, 1)))
    assert model.n_params == sum(int(np.prod(v.shape)) for v in
                                 jax.tree.leaves(jvars["params"]))
    loss = model.train_step(_batch(3), generator=torch.Generator().manual_seed(1))
    log = model.get_current_log()
    assert set(log) == {"l_pix"} and isinstance(log["l_pix"], float)
    assert log["l_pix"] == float(loss)
