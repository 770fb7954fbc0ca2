"""The port's bf16 flagship path (``hsi_dmgasr_tpu_torch/bench.py``) against
the JAX package under the root bench.py's casts.

The casts happen here: the JAX side gets its params cast to bf16 and its
activations cast as bench.py casts them (GAE and UNet inputs in bf16, the
chain state in f32), and runs its Pallas kernels in interpret mode, as the
JAX package's own tests run them on the CPU. The port runs its kernels'
plain versions (CPU tensors). Weights are seeded in the port and bridged.

Tolerances, each with its reason:
  * bf16 fused UNet, port vs JAX ``fuse_blocks=True``: 3e-2 (atol = rtol),
    the JAX package's fused-UNet tolerance (tests/test_fused_conv.py).
    Both round every activation to bf16, in other places; 1.6e-2 on this
    seed, on outputs up to 0.98;
  * the --small bf16 cube at t_start=4, with x_init and the noise given to
    both samplers: 3e-2, the same bound, on a cube in [0, 1]; 1.4e-2 on
    this seed;
  * bf16 GroupNorm: one bf16 ulp (rtol 2^-7, atol 1e-6): both compute in
    f32 and round once;
  * bf16 GAE encode and decode: 3e-2 relative to the largest output, the
    fused-UNet bound, for bf16 activations rounded after every conv;
    7.8e-3 on this seed, on outputs up to 1.1 and 1.5;
  * the overlap average: bands in one or two groups get the same bf16
    sums exactly; the three-way bands (86 and 87 of 102) within one bf16
    ulp of the sum (2^-6 below 4) over the count 3, plus the quotient's
    own rounding (2^-8 below 1), since JAX's scatter-add rounds after
    each add and the port's index_add_ on the CPU sums in f32 and rounds
    once (5 of their 32 averages differ on this seed);
  * bf16 ``init_from_cond`` and one reverse step: f32 results, 1e-6;
  * plain flash at bf16 vs the JAX Pallas flash at bf16: the same bf16
    operands and one rounding of the output, so they differ by f32
    summation order, a rare one-ulp flip of a bf16 p (atol 1e-3) and a
    one-ulp flip of the output (rtol 2^-7, one bf16 ulp at any size);
    9.8e-4 and 4.9e-4 on these seeds;
  * the roofline op lists: equal.
"""

import copy
import functools
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import bench as root_bench
from hsi_dmgasr_tpu.diffusion.gaussian import GaussianDiffusion as JDiffusion
from hsi_dmgasr_tpu.kernels.flash_attention import flash_attention as j_flash
from hsi_dmgasr_tpu.models import networks as j_networks
from hsi_dmgasr_tpu.models.gae import GAE as JGAE
from hsi_dmgasr_tpu.models.unet import GN as JGN
from hsi_dmgasr_tpu.models.unet import UNet as JUNet
from hsi_dmgasr_tpu.utils import roofline as j_roofline
from hsi_dmgasr_tpu_torch import bench
from hsi_dmgasr_tpu_torch.diffusion import gaussian as gaussian_mod
from hsi_dmgasr_tpu_torch.io.convert_torch import load_jax_params
from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa
from hsi_dmgasr_tpu_torch.models.gae import GAE
from hsi_dmgasr_tpu_torch.models.networks import diffusion_for_phase
from hsi_dmgasr_tpu_torch.models.unet import GroupNorm, UNet
from hsi_dmgasr_tpu_torch.utils import roofline
from torch_port_weights import jax_variables, randomize

BF16 = torch.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 3e-2


def _jbf16(tree):
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree)


def _f32(t):
    return t.float().numpy()


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------------ (a) UNet

# 64 channels, 32 groups: dim_out 128 on the up path (the skip concatenated
# under "auto") and 64 (the skip riding the kernel), res projections,
# attention at 4x4 and the Cout = 3 final conv
UNET_KW = dict(in_channel=6, out_channel=3, inner_channel=64, norm_groups=32,
               channel_mults=(1, 2), attn_res=(4,), res_blocks=1, image_size=8)


@pytest.fixture(scope="module")
def unet_case():
    rng = np.random.RandomState(2)
    x = rng.rand(2, 8, 8, 6).astype(np.float32)
    t = np.array([[0.4], [0.8]], np.float32)
    variables = jax_variables(JUNet(**UNET_KW), randomize(UNet(**UNET_KW), 0), x, t)
    return variables, x, t


# "auto" rides the skip at dim_out 64 and concatenates it at 128; True
# rides it at 128 too, with the moment chain off
@pytest.mark.parametrize("fuse_skip,fuse_stats", [("auto", True), (True, False)])
def test_bf16_fused_unet_matches_jax(unet_case, fuse_skip, fuse_stats):
    """The port's bf16 fused UNet against the JAX one under bench.py's casts
    (bf16 params, x.astype(bf16), t.astype(bf16))."""
    variables, x, t = unet_case
    jnet = JUNet(**UNET_KW, fuse_blocks=True, fuse_skip=fuse_skip, fuse_stats=fuse_stats)
    want = jax.jit(jnet.apply)(_jbf16(variables), jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(t, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    net = load_jax_params(UNet(**UNET_KW, fuse_blocks=True, fuse_skip=fuse_skip,
                               fuse_stats=fuse_stats).eval(), variables).to(BF16)
    with torch.inference_mode():
        got = net(torch.tensor(x).to(BF16), torch.tensor(t).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_allclose(_f32(got), _np32(want), atol=TOL, rtol=TOL)


# ------------------------------------------------------------ (b) the cube

def _small_args(**kw):
    args = bench.parse_args(["--small", "--cpu", "--repeats", "1", "--no-profile"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _f32_copy(module):
    return copy.deepcopy(module).float()


@pytest.fixture(scope="module")
def small_bench():
    model = bench.Bench(_small_args(), torch.device("cpu"))
    size, channels = model.size, model.channels
    gae_vars = jax_variables(JGAE(n_subs=8, n_ovls=2, n_colors=channels, n_feats=16),
                             _f32_copy(model.gae), np.zeros((1, 8, 8, channels), np.float32))
    unet_vars = jax_variables(JUNet(in_channel=6, out_channel=3, inner_channel=16,
                                    norm_groups=16, channel_mults=(1, 2), attn_res=(16,),
                                    res_blocks=2, image_size=size),
                              _f32_copy(model.unet), np.zeros((1, size, size, 6), np.float32),
                              np.zeros((1, 1), np.float32))
    return model, gae_vars, unet_vars


def _root_build(args):
    """The root bench.py's super_resolve for ``args``, built without its
    seeded init (the weights are arguments of the function it returns)."""
    def zeros_init(init):
        def fake(self, key, *inputs, **kw):
            shapes = jax.eval_shape(functools.partial(init, self, **kw), key, *inputs)
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        return fake

    with mock.patch.object(JGAE, "init", zeros_init(JGAE.init)), \
            mock.patch.object(JUNet, "init", zeros_init(JUNet.init)), \
            mock.patch.object(j_networks, "init_weights", lambda params, key: params):
        return root_bench.build(args)[0]


def test_small_bf16_cube_matches_root_bench(small_bench):
    """``--small`` at bf16, t_start=4: encode, 4 fused UNet steps, decode,
    through the root bench.py's super_resolve and the port's, with the
    same x_init and noise."""
    model, gae_vars, unet_vars = small_bench
    rng = np.random.RandomState(3)
    cube = rng.rand(1, model.size, model.size, model.channels).astype(np.float32)
    lat = (model.n_groups, model.size, model.size, 3)
    x_init = rng.randn(*lat).astype(np.float32)
    noise = rng.randn(4, *lat).astype(np.float32)

    jargs = SimpleNamespace(small=True, timesteps=20, dtype="bf16", no_fuse=False,
                            no_fuse_skip=False, no_fuse_stats=False, t_start=4, chunk=0)
    super_resolve = _root_build(jargs)
    real_loop = JDiffusion.sample_loop

    def replay(self, denoise_fn, key, **kw):
        return real_loop(self, denoise_fn, key, x_init=x_init, noise_seq=noise, **kw)

    with mock.patch.object(JDiffusion, "sample_loop", replay):
        want = np.asarray(jax.jit(super_resolve)(
            _jbf16(gae_vars), _jbf16(unet_vars), jax.random.PRNGKey(0), cube))
    got = model.super_resolve(torch.tensor(cube), 0, 4, x_init=x_init, noise_seq=noise)
    assert got.dtype == torch.float32 and got.shape == cube.shape
    assert want.min() >= 0.0 and want.max() <= 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_chunks_run_the_same_chain():
    """--chunk splits the latents into sequential chains; with the same
    x_init and noise the cube is the unchunked one (batch 2: 10 latents).
    In f32, 1e-5: in bf16 the CPU's convolutions alone move the UNet's
    output by about 1.5e-2 between a batch of 10 and two of 5."""
    model = bench.Bench(_small_args(dtype="f32"), torch.device("cpu"))
    rng = np.random.RandomState(4)
    cube = torch.tensor(rng.rand(2, model.size, model.size, model.channels).astype(np.float32))
    lat = (2 * model.n_groups, model.size, model.size, 3)
    x_init = rng.randn(*lat).astype(np.float32)
    noise = rng.randn(2, *lat).astype(np.float32)
    whole = model.super_resolve(cube, 0, 2, x_init=x_init, noise_seq=noise)
    chunked = copy.copy(model)
    chunked.chunk = model.n_groups
    parts = chunked.super_resolve(cube, 0, 2, x_init=x_init, noise_seq=noise)
    torch.testing.assert_close(parts, whole, atol=1e-5, rtol=0)


# --------------------------------------------- (c) GN, GAE, the chain's dtypes

def test_bf16_group_norm_matches_jax():
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 6, 5, 32) * 3 + 1).astype(np.float32)
    scale, bias = 1 + 0.2 * rng.randn(32), 0.2 * rng.randn(32)
    params = {"params": {"scale": scale, "bias": bias}}
    want = JGN(num_groups=8).apply(_jbf16(params), jnp.asarray(x, jnp.bfloat16))
    gn = GroupNorm(8, 32, eps=1e-5)
    with torch.no_grad():
        gn.weight.copy_(torch.tensor(scale))
        gn.bias.copy_(torch.tensor(bias))
    got = gn.to(BF16)(torch.tensor(x).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(got.detach()), _np32(want), rtol=2 ** -7, atol=1e-6)


GAE_KW = dict(n_subs=16, n_ovls=4, n_colors=102, n_feats=16)


@pytest.fixture(scope="module")
def gae_case():
    """The flagship's band grouping (G = 9, bands 86-87 in three groups)."""
    x = np.random.RandomState(6).rand(1, 12, 12, 102).astype(np.float32)
    jgae = JGAE(**GAE_KW)
    variables = jax_variables(jgae, randomize(GAE(**GAE_KW), 1), x)
    tgae = load_jax_params(GAE(**GAE_KW).eval(), variables).to(BF16)
    return jgae, _jbf16(variables), tgae, x


def test_bf16_gae_encode_decode_match_jax(gae_case):
    jgae, jvars, tgae, x = gae_case
    xb = jnp.asarray(x, jnp.bfloat16)
    z_want = jgae.apply(jvars, xb, method=JGAE.encode)
    y_want = jgae.apply(jvars, z_want, method=JGAE.decode)
    with torch.no_grad():
        z = tgae.encode(torch.tensor(x).to(BF16))
        y = tgae.decode(torch.tensor(_np32(z_want)).to(BF16))
    assert z.dtype == BF16 and y.dtype == BF16 and y_want.dtype == jnp.bfloat16
    for got, want in ((z, z_want), (y, y_want)):
        want = _np32(want)
        np.testing.assert_allclose(_f32(got), want, atol=TOL * np.abs(want).max(), rtol=0)


def test_bf16_overlap_average_matches_jax(gae_case):
    """The port's index_add_ against the JAX scatter-add, in bf16."""
    jgae, jvars, tgae, _ = gae_case
    dec = np.random.RandomState(7).rand(9, 4, 4, 16).astype(np.float32)
    want = _np32(jgae.apply(jvars, jnp.asarray(dec, jnp.bfloat16), 1, 4, 4,
                            method=JGAE._merge_groups))
    got = tgae._merge_groups(torch.tensor(dec).to(BF16), 1, 4, 4)
    assert got.dtype == BF16
    got = _f32(got)
    three = np.bincount(tgae.idx.numpy(), minlength=102) == 3
    assert np.flatnonzero(three).tolist() == [86, 87]
    np.testing.assert_array_equal(got[..., ~three], want[..., ~three])
    np.testing.assert_allclose(got[..., three], want[..., three], rtol=0,
                               atol=2 ** -6 / 3 + 2 ** -8)


@pytest.fixture(scope="module")
def diffusions():
    opt = {"model": {"beta_schedule": {"val": {"schedule": "cosine", "n_timestep": 20,
                                               "linear_start": 1e-6, "linear_end": 1e-2}},
                     "diffusion": {"conditional": True}}}
    return j_networks.diffusion_for_phase(opt, "val"), diffusion_for_phase(opt, "val")


def test_bf16_init_from_cond_and_step_match_jax(diffusions):
    """A bf16 cond: the truncated start and one reverse step are f32 on both
    sides (JAX's f32 scalars promote; the port widens explicitly)."""
    jdiff, diff = diffusions
    rng = np.random.RandomState(8)
    cond = rng.randn(2, 5, 5, 3).astype(np.float32)
    eps = rng.randn(2, 5, 5, 3).astype(np.float32)
    noise = rng.randn(2, 5, 5, 3).astype(np.float32)
    cb = jnp.asarray(cond, jnp.bfloat16)
    with mock.patch.object(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(eps)):
        x_want = jdiff.init_from_cond(cb, jax.random.PRNGKey(0), 4)
    with mock.patch.object(gaussian_mod.torch, "randn", lambda *a, **kw: torch.tensor(eps)):
        x = diff.init_from_cond(torch.tensor(cond).to(BF16), 4)
    assert x.dtype == torch.float32 and x_want.dtype == jnp.float32
    np.testing.assert_allclose(x.numpy(), np.asarray(x_want), atol=1e-6, rtol=1e-6)

    def jdenoise(inp, level):   # a bf16 eps, as the bf16 UNet returns it
        return (inp[..., 3:] * 0.5 + inp[..., :3] * level[:, :, None, None]).astype(jnp.bfloat16)

    def denoise(inp, level):
        return (inp[..., 3:] * 0.5 + inp[..., :3] * level[:, :, None, None]).to(BF16)

    step_want = jdiff._step(jdenoise, x_want, 3, None, cb, noise=jnp.asarray(noise))
    step = diff._step(denoise, x, 3, torch.tensor(cond).to(BF16), noise=torch.tensor(noise))
    assert step.dtype == torch.float32 and step_want.dtype == jnp.float32
    np.testing.assert_allclose(step.numpy(), np.asarray(step_want), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- (d) flash

@pytest.mark.parametrize("s,h,d", [(300, 1, 128), (200, 2, 256)])
def test_plain_flash_bf16_matches_jax_flash(s, h, d):
    rng = np.random.RandomState(9)
    qkv = rng.randn(2, s, h, 3 * d).astype(np.float32)
    scale = 1.0 / math.sqrt(h * d)   # a Python float, as the UNet passes it
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in np.split(qkv, 3, axis=-1))
    with pltpu.force_tpu_interpret_mode():
        want = j_flash(jq, jk, jv, scale)
    q, k, v = torch.tensor(qkv).to(BF16).split(d, dim=-1)
    got = fa.flash_attention_plain(q, k, v, scale)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16 and got.shape == (2, s, h, d)
    np.testing.assert_allclose(_f32(got), _np32(want), atol=1e-3, rtol=2 ** -7)


# ------------------------------------------------------------- (e) roofline

@pytest.mark.parametrize("small", [False, True])
def test_roofline_ops_match_jax(small):
    size, _, inner, mults, *_ = bench.geometry(small)
    kw = dict(inner=inner, mults=tuple(mults))
    mine = [(o.name, o.flops, o.bytes) for o in roofline.unet_step_ops(9, size, **kw)]
    ref = [(o.name, o.flops, o.bytes) for o in j_roofline.unet_step_ops(9, size, **kw)]
    assert mine == ref
    rl = roofline.step_roofline(9, size, "NVIDIA H100 80GB HBM3", **kw)
    jrl = j_roofline.step_roofline(9, size, **kw)
    assert (rl["total_gflop"], rl["total_gb"]) == (jrl["total_gflop"], jrl["total_gb"])
    assert (rl["peak_tflops"], rl["peak_gbps"]) == (989.0, 3350.0)


def test_roofline_refuses_an_unknown_device():
    with pytest.raises(ValueError, match="no roofline peaks"):
        roofline.device_peaks("TPU v5 lite")


# ------------------------------------------------------------ (f) the entry

def test_cli_prints_one_json_line_on_the_cpu():
    """One intra-op thread: the test shares the CPU with other workers, and
    a second process with a thread per core there ran 200x slower."""
    proc = subprocess.run(
        [sys.executable, "-m", "hsi_dmgasr_tpu_torch.bench", "--small", "--cpu",
         "--repeats", "1", "--no-profile"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "dmgasr_x4_64x64x31_cube_seconds" and out["unit"] == "s"
    assert out["t_start"] == 4 and out["value"] > 0
    assert out["full_chain"]["timesteps"] == 20 and out["full_chain"]["value"] > 0
    assert "vs_baseline" not in out and "profile" not in out


def test_cli_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--small", "--repeats", "1"])


def test_gae_pretrained_file_is_refused(tmp_path, monkeypatch):
    ckpt = tmp_path / "GAE_4_Pav.pth"
    ckpt.write_bytes(b"")
    monkeypatch.setenv("GAE_PRETRAINED", str(ckpt))
    with pytest.raises(NotImplementedError, match="load_torch_gae"):
        bench.Bench(bench.parse_args([]), torch.device("cpu"))
