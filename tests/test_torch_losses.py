"""The port's HSI losses and random_mask against the JAX package and the
reference torch goldens (tests/golden/loss_golden.npz), on the CPU.

Tolerances: values rtol 1e-5 (tests/test_losses.py's own); gradients
rtol 1e-4 with atol 1e-4 of the largest |g| (f32 sums in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.models.gae import random_mask as j_random_mask
from hsi_dmgasr_tpu.train import losses as J
from hsi_dmgasr_tpu_torch.models.gae import random_mask
from hsi_dmgasr_tpu_torch.train import losses as P

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "loss_golden.npz")
# name -> (port function, JAX function, keyword arguments)
LOSSES = {
    "h_loss": (P.h_loss, J.h_loss, dict(la1=0.3, la2=0.1)),
    "cal_sam": (P.cal_sam, J.cal_sam, {}),
    "hybrid_loss": (P.hybrid_loss, J.hybrid_loss, {}),
    "spe_loss": (P.spe_loss, J.spe_loss, dict(n=2)),
}


def _cubes(seed, shape=(2, 16, 16, 31)):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_reference_golden(name):
    g = np.load(GOLDEN)
    y, gt = (torch.from_numpy(np.moveaxis(g[k], 1, -1).copy()) for k in ("y", "gt"))
    fn, _, kw = LOSSES[name]
    np.testing.assert_allclose(float(fn(y, gt, **kw)), float(g[name]), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_jax(name):
    y, gt = _cubes(1)
    fn, jfn, kw = LOSSES[name]
    want = float(jfn(jnp.asarray(y), jnp.asarray(gt), **kw))
    np.testing.assert_allclose(float(fn(torch.from_numpy(y), torch.from_numpy(gt), **kw)),
                               want, rtol=1e-5)


def test_cal_gradient_matches_jax():
    y, _ = _cubes(2, (2, 8, 9, 7))
    want = np.asarray(J.cal_gradient(jnp.asarray(y)))
    got = P.cal_gradient(torch.from_numpy(y)).numpy()
    assert got.shape == (2, 7, 8, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", ["h_loss", "cal_sam"])
def test_loss_gradient_matches_jax_grad(name):
    """d loss / d y on generic random cubes (no cosine at the clip's edge,
    where jnp.clip's gradient splits a tie and torch.clamp's does not)."""
    y, gt = _cubes(3)
    fn, jfn, kw = LOSSES[name]
    want = np.asarray(jax.grad(lambda a: jfn(a, jnp.asarray(gt), **kw))(jnp.asarray(y)))
    yt = torch.from_numpy(y).requires_grad_(True)
    fn(yt, torch.from_numpy(gt), **kw).backward()
    got = yt.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_cal_sam_zero_spectrum_has_a_finite_gradient():
    """At an all-zero spectrum the divisor guard keeps the value finite in
    both packages; torch's norm gradient there is 0, jnp's is NaN (a
    behaviour of the port, recorded in ROADMAP.md)."""
    y, gt = _cubes(4, (1, 4, 4, 8))
    y[0, 1, 2] = 0.0
    yt = torch.from_numpy(y).requires_grad_(True)
    loss = P.cal_sam(yt, torch.from_numpy(gt))
    np.testing.assert_allclose(loss.item(), float(J.cal_sam(jnp.asarray(y), jnp.asarray(gt))),
                               rtol=1e-5)
    loss.backward()
    assert torch.isfinite(yt.grad).all()


def test_random_mask_replays_the_jax_draw_and_draws_its_own():
    x = np.random.RandomState(5).rand(2, 8, 8, 31).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = np.asarray(j_random_mask(key, jnp.asarray(x), p=0.6))
    mask = np.array(jax.random.uniform(key, x.shape) > 0.6)
    got = random_mask(torch.from_numpy(x), 0.6, mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)

    xt = torch.from_numpy(x)
    a = random_mask(xt, 0.6, generator=torch.Generator().manual_seed(1))
    b = random_mask(xt, 0.6, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = a != 0
    assert torch.equal(a[kept], xt[kept])
    assert 0.3 < kept.float().mean().item() < 0.5
