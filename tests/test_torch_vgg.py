"""The port's VGG19 and the perceptual stage-1 step against the JAX package.

torchvision and its pretrained weights are not here, so the weights are
seeded (He-normal, so the logits are of order one rather than vanishing
as torch's default init makes them) in the port's VGG19, whose modules
are torchvision's (checked against tools/make_vgg_golden.build_torch_vgg19
built on the meta device), and carried to the JAX VGG19 by the JAX
package's own converter (state_dict_to_flax). Tolerances: logits atol
2e-3, rtol 1e-3 and features atol 1e-4, rtol 1e-3 (tests/test_vgg.py's);
the perceptual step's loss rtol 1e-5 and gradients rtol 1e-4 with atol
1e-4 of each leaf's largest |g| (test_torch_stage1.py's). The model holds
144 M parameters, so one module-scoped copy serves every case."""

import jax
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.io.convert_torch import state_dict_to_flax
from hsi_dmgasr_tpu.models.vgg import VGG19 as JVGG19
from hsi_dmgasr_tpu.train.stage1_gae import make_vgg_perceptual_fn as j_make_vgg_perceptual_fn
from hsi_dmgasr_tpu_torch.io.convert_torch import load_torch_vgg19
from hsi_dmgasr_tpu_torch.models.networks import init_weights
from hsi_dmgasr_tpu_torch.models.vgg import VGG19
from hsi_dmgasr_tpu_torch.train.stage1_gae import make_vgg_perceptual_fn
from test_torch_stage1 import assert_step_matches, jax_and_port
from tools.make_vgg_golden import build_torch_vgg19


@pytest.fixture(scope="module")
def vgg():
    """(port VGG19, its weights as JAX variables)."""
    net = init_weights(VGG19(), torch.Generator().manual_seed(3), init_type="kaiming").eval()
    variables = state_dict_to_flax({k: v.numpy() for k, v in net.state_dict().items()})
    return net, variables


def test_layout_is_torchvision_s():
    with torch.device("meta"):
        ref = build_torch_vgg19().state_dict()
    for extract in ("logits", "features"):
        with torch.device("meta"):
            got = VGG19(extract=extract).state_dict()
        want = {k: v for k, v in ref.items() if extract == "logits" or k.startswith("features.")}
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("hw", [64, 96])
def test_vgg19_logits_match_jax(vgg, hw):
    """The adaptive 7x7 pool below the bins (64 -> 2x2) and not dividing
    them (96 -> 3x3), and torch's NCHW flatten order."""
    net, variables = vgg
    x = np.random.RandomState(5).rand(2, hw, hw, 3).astype(np.float32)
    want = np.asarray(JVGG19().apply(variables, x))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1  # seeded logits that are not vanishingly small
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


def test_vgg19_features_match_jax_and_load_from_a_file(vgg, tmp_path):
    """A features-only state_dict saved as a .pth loads through
    load_torch_vgg19 into VGG19(extract='features') as it is."""
    net, variables = vgg
    path = tmp_path / "vgg19_features.pth"
    torch.save({k: v for k, v in net.state_dict().items() if k.startswith("features.")}, path)
    feat = VGG19(extract="features")
    feat.load_state_dict(load_torch_vgg19(str(path)))
    x = np.random.RandomState(6).rand(1, 64, 64, 3).astype(np.float32)
    want = np.asarray(JVGG19(extract="features").apply(
        {"params": {k: v for k, v in variables["params"].items() if k.startswith("features")}},
        x))
    with torch.no_grad():
        got = feat(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 2, 2, 512)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_perceptual_fn_draws_and_replays_bands(vgg):
    net, variables = vgg
    rng = np.random.RandomState(0)
    hr = rng.rand(2, 32, 32, 31).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = float(j_make_vgg_perceptual_fn(variables)(hr * 0.5, hr, key))
    bands = torch.from_numpy(np.array(jax.random.randint(key, (3,), 0, 31)))
    fn = make_vgg_perceptual_fn(net)
    with torch.no_grad():
        got = fn(torch.from_numpy(hr * 0.5), torch.from_numpy(hr), bands=bands).item()
        a = fn(torch.from_numpy(hr * 0.5), torch.from_numpy(hr),
               generator=torch.Generator().manual_seed(1)).item()
        b = fn(torch.from_numpy(hr * 0.5), torch.from_numpy(hr),
               generator=torch.Generator().manual_seed(1)).item()
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert a == b


def test_perceptual_step_matches_jax(vgg):
    """HLoss plus the perceptual term at weight 1 (the shipped 1e-3 would
    hide it under the rtol): the JAX step's band draw, injected."""
    net, variables = vgg
    jtr, ptr = jax_and_port(perceptual=(j_make_vgg_perceptual_fn(variables),
                                        make_vgg_perceptual_fn(net)), perceptual_weight=1.0)
    hr = np.random.RandomState(7).rand(2, 32, 32, 31).astype(np.float32)
    key = jax.random.PRNGKey(8)
    bands = torch.from_numpy(np.array(jax.random.randint(key, (3,), 0, 31)))
    assert_step_matches(jtr, ptr, hr, key, bands=bands)
