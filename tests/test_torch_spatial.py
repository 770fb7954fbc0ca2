"""Spatially sharded fused inference: the port's H-shard path against its
single-device path and against the JAX package's shard_map path.

Ranks are gloo processes spawned over a ``file://`` store in tmp_path
(``parallel.multihost.launch``), each pinned to one intra-op thread. One
spawn per mesh, (1, 2) and (2, 2), runs every port-side case and returns
what each rank holds. The JAX side runs ``shard_map`` over the same
('data', 'space') grid of the JAX package's 8-device virtual CPU mesh
(tests/conftest.py), its fused Block in Pallas interpret mode. The
spawned ranks import this module, so it imports JAX only inside tests.
Inputs are the shapes of tests/test_spatial_fused.py and
tests/test_pipeline.py, with B = 2 where B is split over 'data'.

Tolerances:
  * sharded against single-device in the port: the JAX tests' 1e-4
    (f32 convs over another extent of H); 1e-5 for the 3x3 and up2
    convs, as tests/test_spatial_fused.py holds them; the reduced
    GroupNorm moments (and scale, shift) bit for bit;
  * against JAX: atol = rtol = 0.05 where the fused Block runs, the
    plain-vs-JAX tolerance of tests/test_torch_fused_conv.py (the JAX
    kernel rounds the activation to bf16, the port's f32 path does not);
    1e-4 (1e-5 for the convs) for the ops without that rounding, and for
    the unfused chain; the fused chain as its test says.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu_torch.io.convert_torch import load_state_dict
from hsi_dmgasr_tpu_torch.kernels import fused_conv as tfc
from hsi_dmgasr_tpu_torch.models.gae import GAE
from hsi_dmgasr_tpu_torch.models.unet import UNet
from hsi_dmgasr_tpu_torch.ops.fused_up import up2_conv3x3
from hsi_dmgasr_tpu_torch.parallel import mesh as pmesh
from hsi_dmgasr_tpu_torch.parallel import multihost, spatial
from hsi_dmgasr_tpu_torch.pipeline import DMGASRPipeline
from hsi_dmgasr_tpu_torch.train.ddpm_model import DDPMModel

MESHES = [(1, 2), (2, 2)]
TOL, CONV_TOL, JAX_TOL = 1e-4, 1e-5, 0.05
UNET_KW = dict(in_channel=6, out_channel=3, inner_channel=8, norm_groups=4,
               channel_mults=(1, 2), attn_res=(8,), res_blocks=1, dropout=0.0,
               image_size=16, fuse_blocks=True)
GAE_CFG = {"n_subs": 8, "n_ovls": 2, "n_colors": 31, "n_feats": 16, "G": 5}
GAE_KW = {k: GAE_CFG[k] for k in ("n_subs", "n_ovls", "n_colors", "n_feats")}
OPT = {  # tests/test_pipeline.py's TINY_OPT
    "gpu_ids": [0],
    "model": {
        "which_model_G": "sr3", "finetune_norm": False,
        "unet": {"in_channel": 6, "out_channel": 3, "inner_channel": 8, "norm_groups": 4,
                 "channel_multiplier": [1, 2], "attn_res": [8], "res_blocks": 1,
                 "dropout": 0.0},
        "beta_schedule": {p: {"schedule": "cosine", "n_timestep": 4, "linear_start": 1e-6,
                              "linear_end": 1e-2} for p in ("train", "val")},
        "diffusion": {"image_size": 16, "channels": 3, "conditional": True},
    },
    "train": {"optimizer": {"type": "adam", "lr": 1e-4}},
    "path": {},
}
# the fused-Block cases of tests/test_spatial_fused.py: (C, Cout, extras)
BLOCKS = {"tb": (16, 16, "tb"), "res": (16, 32, "res")}


def _block_inputs(rng, b, h, w, c, cout, extras, c2=0):
    ct = c + c2
    d = dict(x=rng.randn(b, h, w, c), gn_scale=rng.rand(ct) + 0.5,
             gn_bias=rng.randn(ct) * 0.1,
             kernel=rng.randn(3, 3, ct, cout) / np.sqrt(9 * ct), bias=rng.randn(cout) * 0.1)
    if c2:
        d["x2"] = rng.randn(b, h, w, c2)
    if "tb" in extras:
        d["time_bias"] = rng.randn(b, cout)
    if "res" in extras:
        d["residual"] = rng.randn(b, h, w, cout)
    return {k: v.astype(np.float32) for k, v in d.items()}


def _case():
    """Every input, from numpy seeds, and the weights as state_dicts."""
    from torch_port_weights import randomize

    rng = np.random.RandomState(0)
    case = {
        "conv_x": rng.randn(2, 16, 12, 8), "conv_k": rng.randn(3, 3, 8, 6) * 0.1,
        "conv_b": rng.randn(6), "conv2_k": rng.randn(3, 3, 8, 8) * 0.1,
        "up_x": rng.randn(2, 8, 8, 4), "up_k": rng.randn(3, 3, 4, 4) * 0.2,
        "up_b": rng.randn(4), "unet_x": rng.randn(2, 16, 16, 6), "unet_t": rng.rand(2, 1),
        "sr": rng.rand(1, 16, 16, 31),
    }
    case = {k: v.astype(np.float32) for k, v in case.items()}
    case["blocks"] = {name: _block_inputs(np.random.RandomState(3), 2, 16, 8, c, cout, ex)
                      for name, (c, cout, ex) in BLOCKS.items()}
    chain = _block_inputs(np.random.RandomState(4), 2, 16, 8, 16, 16, "", c2=16)
    r = np.random.RandomState(5)
    chain.update(k2=(r.randn(3, 3, 16, 16) / np.sqrt(144)).astype(np.float32),
                 b2=(r.randn(16) * 0.1).astype(np.float32),
                 gs2=(r.rand(16) + 0.5).astype(np.float32),
                 gb2=(r.randn(16) * 0.1).astype(np.float32))
    case["chain"] = chain
    case["unet_sd"] = randomize(UNet(**UNET_KW), 5).state_dict()
    case["gae_sd"] = randomize(GAE(**GAE_KW), 1).state_dict()
    case["ddpm_sd"] = randomize(DDPMModel(OPT, device="cpu").unet, 2).state_dict()
    return case


def _t(a):
    return torch.as_tensor(a)


def _block_run(d, mesh=None):
    """The port's plain fused Block on d (a dict of tensors), sharded when
    ``mesh`` is given (d then holds this rank's block)."""
    kw = dict(d)
    if mesh is not None:
        kw["halo"] = spatial.exchange_halo(kw["x"], mesh)
        if "x2" in kw:
            kw["halo2"] = spatial.exchange_halo(kw["x2"], mesh)
    return tfc.gn_swish_conv3x3(**kw, num_groups=8, mesh=mesh)


def _chain_run(d, mesh=None):
    """Skip riding (x2) and the moment chain, as in tests/test_spatial_fused.py."""
    kw = {k: d[k] for k in ("x", "gn_scale", "gn_bias", "kernel", "bias", "x2")}
    if mesh is not None:
        kw["halo"] = spatial.exchange_halo(kw["x"], mesh)
        kw["halo2"] = spatial.exchange_halo(kw["x2"], mesh)
    y, stats = tfc.gn_swish_conv3x3(**kw, num_groups=8, emit_stats=True, mesh=mesh)
    halo = spatial.exchange_halo(y, mesh) if mesh is not None else None
    return tfc.gn_swish_conv3x3(y, d["gs2"], d["gb2"], d["k2"], d["b2"], stats_in=stats,
                                num_groups=8, mesh=mesh, halo=halo)


def _pipeline(case):
    """The port's tiny pipeline, its UNet unfused as configured (the
    spatial path and ``UNet.fusing`` fuse it)."""
    ddpm = DDPMModel(OPT, device="cpu")
    load_state_dict(ddpm.unet, case["ddpm_sd"])
    return DMGASRPipeline(OPT, case["gae_sd"], GAE_CFG, ddpm=ddpm, device="cpu")


def _rank(rank, dev, shape, case, jax_noise):
    """Every port-side case on this rank: (its sharded results with the
    in-rank bitwise check, the single-device results on rank 0)."""
    torch.set_num_threads(1)
    mesh = pmesh.dmgasr_mesh(*shape, device="cpu")

    def mine(a):  # this rank's (data, space) block
        return pmesh.shard_spatial(mesh, _t(a))

    def rows(a):  # this rank's 'data' rows
        n = a.shape[0] // shape[0]
        return _t(a)[mesh.data_idx * n:(mesh.data_idx + 1) * n]

    def blk(inp):  # this rank's block of a Block's inputs
        return {k: (mine(v) if k in ("x", "x2", "residual") else
                    rows(v) if k == "time_bias" else _t(v)) for k, v in inp.items()}

    out, single = {}, {}
    with torch.no_grad():
        x = mine(case["conv_x"])
        out["halo"] = torch.cat(spatial.exchange_halo(x, mesh), 1)
        out["masked"] = torch.cat(spatial.edge_mask(*spatial.exchange_halo(x, mesh), mesh), 1)
        out["conv1"] = spatial.conv3x3_spatial(x, _t(case["conv_k"]), _t(case["conv_b"]), mesh)
        out["conv2"] = spatial.conv3x3_spatial(x, _t(case["conv2_k"]), None, mesh, stride=2)
        out["up2"] = spatial.up2_conv3x3_spatial(mine(case["up_x"]), _t(case["up_k"]),
                                                 _t(case["up_b"]), mesh)
        # the reduced moments, and the scale and shift, bit for bit in-rank
        d = case["blocks"]["res"]
        x, full, gs, gb = mine(d["x"]), rows(d["x"]), _t(d["gn_scale"]), _t(d["gn_bias"])
        st_sh = tfc._reduce_row_stats(tfc._row_moments(x), mesh)
        st_one = tfc._reduce_row_stats(tfc._row_moments(full))
        ss_sh = tfc.gn_scale_shift(x, gs, gb, num_groups=8, mesh=mesh)
        ss_one = tfc.gn_scale_shift(full, gs, gb, num_groups=8)
        out["bitwise"] = all(torch.equal(a, b) for a, b in zip(st_sh + ss_sh, st_one + ss_one))
        for name, inp in case["blocks"].items():
            out[f"block_{name}"] = _block_run(blk(inp), mesh)
        out["block_chain"] = _chain_run(blk(case["chain"]), mesh)

        net = load_state_dict(UNet(**UNET_KW).eval(), case["unet_sd"])
        out["unet"] = net(mine(case["unet_x"]), rows(case["unet_t"]), spatial=mesh)

        if rank == 0:  # the single-device port, on one thread too
            single = {
                "conv1": _conv(case["conv_x"], case["conv_k"], case["conv_b"], 1),
                "conv2": _conv(case["conv_x"], case["conv2_k"], None, 2),
                "up2": up2_conv3x3(_t(case["up_x"]), _t(case["up_k"]), _t(case["up_b"])),
                "unet": net(_t(case["unet_x"]), _t(case["unet_t"])),
                "block_chain": _chain_run({k: _t(v) for k, v in case["chain"].items()}),
            }
            for name, inp in case["blocks"].items():
                single[f"block_{name}"] = _block_run({k: _t(v) for k, v in inp.items()})

    pipe = _pipeline(case)
    unet = pipe.ddpm.eval_unet

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    out["sr_fused"] = pipe.super_resolve_spatial(case["sr"], mesh, gen(3), replay_noise=True)
    out["sr_unfused"] = pipe.super_resolve_spatial(case["sr"], mesh, gen(4), fused=False)
    x_init, noise = jax_noise
    out["sr_fused_jax_noise"] = pipe.super_resolve_spatial(case["sr"], mesh, x_init=x_init,
                                                           noise_seq=noise)
    out["sr_unfused_jax_noise"] = pipe.super_resolve_spatial(
        case["sr"], mesh, fused=False, x_init=x_init, noise_seq=noise)
    out["sr_drawn"] = pipe.super_resolve_spatial(case["sr"], mesh, gen(5))
    if rank == 0:
        with unet.fusing():
            single["sr_fused"] = pipe.super_resolve(case["sr"], gen(3))
        single["sr_unfused"] = pipe.super_resolve(case["sr"], gen(4))
    out["gathered"] = dict(mesh.gathered)
    return out, single


def _conv(x, k, b, stride):
    y = torch.nn.functional.conv2d(_t(x).permute(0, 3, 1, 2), _t(k).permute(3, 2, 0, 1),
                                   stride=stride, padding=1)
    if b is not None:
        y = y + _t(b)[:, None, None]
    return y.permute(0, 2, 3, 1)


def _assemble(blocks, shape):
    """The global array from each rank's (data, space) block, rank order."""
    n_data, n_space = shape
    return np.concatenate([np.concatenate([np.asarray(blocks[d * n_space + s])
                                           for s in range(n_space)], 1)
                           for d in range(n_data)], 0)


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here and not at the top (the ranks import
    this module)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from hsi_dmgasr_tpu.kernels import fused_conv as jfc
    from hsi_dmgasr_tpu.models import GAE as JGAE
    from hsi_dmgasr_tpu.models.networks import define_G as j_define_G
    from hsi_dmgasr_tpu.models.networks import diffusion_for_phase as j_diffusion
    from hsi_dmgasr_tpu.models.unet import UNet as JUNet
    from hsi_dmgasr_tpu.parallel import spatial as jsp
    from hsi_dmgasr_tpu.pipeline import DMGASRPipeline as JPipeline
    from torch_port_weights import jax_variables

    return SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def case():
    return _case()


@pytest.fixture(scope="module")
def jax_pipe(jx, case):
    """The JAX pipeline on the same weights, with the fused UNet the JAX
    spatial sampler clones."""
    gae_vars = jx.jax_variables(jx.JGAE(**GAE_KW), load_state_dict(GAE(**GAE_KW), case["gae_sd"]),
                                np.zeros((1, 16, 16, 31), np.float32))
    junet, _ = jx.j_define_G(OPT)
    unet_vars = jx.jax_variables(junet, load_state_dict(DDPMModel(OPT, device="cpu").unet,
                                                        case["ddpm_sd"]),
                                 np.zeros((1, 16, 16, 6), np.float32),
                                 np.zeros((1, 1), np.float32))
    ddpm = SimpleNamespace(unet=junet, variables=unet_vars, eval_params=unet_vars["params"],
                           val_diffusion=jx.j_diffusion(OPT, "val"))
    return jx.JPipeline(OPT, gae_vars, GAE_CFG, ddpm=ddpm)


def _jax_mesh(jx, shape):
    return jx.Mesh(np.array(jx.jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                   ("data", "space"))


def _jax_noise(jx, shape, key):
    """The draws of the JAX pipeline's replay_noise (pipeline.py:277-287):
    over the wrap-padded group batch, of which the port replays the first
    B*G (the padded groups are dropped)."""
    n = 5 + (-5) % shape[0]
    k_init, k_steps = jx.jax.random.split(key)
    x_init = jx.jax.random.normal(k_init, (n, 16, 16, 3), jx.jnp.float32)
    noise = jx.jax.vmap(lambda k: jx.jax.random.normal(k, (n, 16, 16, 3), jx.jnp.float32))(
        jx.jax.random.split(k_steps, 4))
    return np.asarray(x_init)[:5], np.asarray(noise)[:, :5]


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def ranks(request, case, jx, tmp_path_factory):
    shape = request.param
    noise = _jax_noise(jx, shape, jx.jax.random.PRNGKey(21))
    store = tmp_path_factory.mktemp("store") / "rendezvous"
    res = multihost.launch(_rank, shape[0] * shape[1], f"file://{store}",
                           args=(shape, case, noise), device="cpu")
    return SimpleNamespace(shape=shape, sharded=[r[0] for r in res], single=res[0][1],
                           noise=noise)


def _got(r, key):
    return _assemble([o[key].numpy() for o in r.sharded], r.shape)


def _shmap(jx, shape, fn, in_specs, out_specs):
    return jx.jax.jit(jx.shard_map(fn, mesh=_jax_mesh(jx, shape), in_specs=in_specs,
                                   out_specs=out_specs, check_rep=False))


def test_exchange_halo_and_edge_mask(ranks, jx, case):
    sh = jx.P("data", "space")
    for key, masked in (("halo", False), ("masked", True)):
        def fn(x, masked=masked):
            rows = jx.jsp.exchange_halo(x, "space")
            rows = jx.jsp.edge_mask(*rows, "space") if masked else rows
            return jx.jnp.concatenate(rows, 1)
        want = np.asarray(_shmap(jx, ranks.shape, fn, (sh,), sh)(case["conv_x"]))
        np.testing.assert_array_equal(_got(ranks, key), want)


@pytest.mark.parametrize("key", ["conv1", "conv2", "up2"])
def test_convs_match_single_and_jax(ranks, jx, case, key):
    got = _got(ranks, key)
    np.testing.assert_allclose(got, ranks.single[key].numpy(), atol=CONV_TOL, rtol=CONV_TOL)
    stride = 2 if key == "conv2" else 1

    def fn(x, k, b=None):
        if key == "up2":
            return jx.jsp.up2_conv3x3_spatial(x, k, b, "space")
        return jx.jsp.conv3x3_spatial(x, k, b, "space", stride=stride)

    if key == "up2":
        args = (case["up_x"], case["up_k"], case["up_b"])
    elif key == "conv2":
        args = (case["conv_x"], case["conv2_k"])
    else:
        args = (case["conv_x"], case["conv_k"], case["conv_b"])
    sh, rep = jx.P("data", "space"), jx.P()
    want = np.asarray(_shmap(jx, ranks.shape, fn, (sh,) + (rep,) * (len(args) - 1), sh)(*args))
    np.testing.assert_allclose(got, want, atol=CONV_TOL, rtol=CONV_TOL)


def test_reduced_moments_bitwise(ranks):
    assert all(o["bitwise"] for o in ranks.sharded)


@pytest.mark.parametrize("name", ["tb", "res", "chain"])
def test_fused_block_with_halo(ranks, jx, case, name):
    got = _got(ranks, f"block_{name}")
    np.testing.assert_allclose(got, ranks.single[f"block_{name}"].numpy(), atol=TOL, rtol=TOL)
    sh, rep = jx.P("data", "space"), jx.P()
    if name == "chain":
        d = case["chain"]

        def fn(x, x2):
            halo = jx.jsp.exchange_halo(x, "space")
            y, st = jx.jfc.gn_swish_conv3x3(
                x, d["gn_scale"], d["gn_bias"], d["kernel"], d["bias"], x2=x2, num_groups=8,
                interpret=True, emit_stats=True, axis_name="space", halo=halo,
                halo2=jx.jsp.exchange_halo(x2, "space"))
            return jx.jfc.gn_swish_conv3x3(
                y, d["gs2"], d["gb2"], d["k2"], d["b2"], stats_in=st, num_groups=8,
                interpret=True, axis_name="space", halo=jx.jsp.exchange_halo(y, "space"))
        want = _shmap(jx, ranks.shape, fn, (sh, sh), sh)(d["x"], d["x2"])
    else:
        d = case["blocks"][name]
        extra = "time_bias" if "time_bias" in d else "residual"

        def fn(x, e):
            return jx.jfc.gn_swish_conv3x3(
                x, d["gn_scale"], d["gn_bias"], d["kernel"], d["bias"], num_groups=8,
                interpret=True, axis_name="space", halo=jx.jsp.exchange_halo(x, "space"),
                **{extra: e})
        espec = jx.P("data") if extra == "time_bias" else sh
        want = _shmap(jx, ranks.shape, fn, (sh, espec), sh)(d["x"], d[extra])
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=JAX_TOL, rtol=JAX_TOL)


def test_fused_unet(ranks, jx, case):
    got = _got(ranks, "unet")
    np.testing.assert_allclose(got, ranks.single["unet"].numpy(), atol=TOL, rtol=TOL)
    kw = dict(UNET_KW)
    variables = jx.jax_variables(jx.JUNet(**kw), load_state_dict(UNet(**kw), case["unet_sd"]),
                                 case["unet_x"], case["unet_t"])
    junet = jx.JUNet(**kw, spatial_axis="space")
    fn = _shmap(jx, ranks.shape, lambda v, x, t: junet.apply(v, x, t, train=False),
                (jx.P(), jx.P("data", "space"), jx.P("data")), jx.P("data", "space"))
    want = np.asarray(fn(variables, case["unet_x"], case["unet_t"]), np.float32)
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=JAX_TOL)


def test_super_resolve_spatial_matches_single(ranks):
    for o in ranks.sharded:
        for key in ("sr_fused", "sr_unfused"):
            np.testing.assert_allclose(o[key].numpy(), ranks.single[key].numpy(), atol=TOL,
                                       rtol=TOL, err_msg=key)
        y = o["sr_drawn"]
        assert y.shape == (1, 16, 16, 31) and float(y.min()) >= 0 and float(y.max()) <= 1
        for key in ("sr_fused", "sr_unfused", "sr_drawn"):
            torch.testing.assert_close(o[key], ranks.sharded[0][key], rtol=0, atol=0)
    g = ranks.sharded[0]["gathered"]
    assert g["halo"] > 0 and g["moments"] > 0 and g["attention"] > 0 and g["output"] > 0


def test_super_resolve_spatial_matches_jax(ranks, jx, jax_pipe, case):
    """Both chains replay the JAX pipeline's draws. The unfused chain is
    held to the JAX package's sampler at 1e-4. The fused one: over four
    steps from pure noise the JAX kernel's bf16 activations move the JAX
    cube by up to 0.14 from the JAX package's own unfused cube on the same
    draws (tests/test_torch_pipeline.py says the same of its from-noise
    case), so the port's fused cube is held within the Block tolerance of
    the JAX unfused cube, and of the JAX fused cube beyond that drift."""
    key = jx.jax.random.PRNGKey(21)
    mesh = _jax_mesh(jx, ranks.shape)
    fused = np.asarray(jax_pipe.super_resolve_spatial(case["sr"], mesh, key=key, fused=True,
                                                      replay_noise=True))
    x_init, noise = ranks.noise
    d = jax_pipe.ddpm
    cond = jax_pipe._fold(jax_pipe.encode(case["sr"]))
    z = d.val_diffusion.sample_loop(lambda x, t: d.unet.apply(d.variables, x, t), key,
                                    cond=cond, x_init=x_init, noise_seq=noise)
    unfused = np.clip(np.asarray(jax_pipe.decode(jax_pipe._unfold(z, 1))), 0, 1)
    got = ranks.sharded[0]["sr_unfused_jax_noise"].numpy()
    np.testing.assert_allclose(got, unfused, atol=TOL, rtol=TOL)
    got = ranks.sharded[0]["sr_fused_jax_noise"].numpy()
    np.testing.assert_allclose(got, unfused, atol=JAX_TOL, rtol=JAX_TOL)
    drift = np.abs(unfused - fused)
    assert (np.abs(got - fused) <= JAX_TOL + JAX_TOL * np.abs(fused) + drift).all()


def test_refusals():
    """An odd H_loc at stride 2, an unfused Block under ``spatial``, and a
    mesh with too few ranks (a single process has one)."""
    mesh = pmesh.dmgasr_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="even H_loc"):
        spatial.conv3x3_spatial(torch.zeros(1, 5, 4, 2), torch.zeros(3, 3, 2, 2), None, mesh,
                                stride=2)
    x, t = torch.zeros(1, 16, 16, 6), torch.full((1, 1), 0.5)
    with pytest.raises(NotImplementedError, match="fused"):
        UNet(**dict(UNET_KW, fuse_blocks=False)).eval()(x, t, spatial=mesh)
    net = UNet(**UNET_KW)
    with pytest.raises(NotImplementedError, match="fused"):
        net.train()(x, t, spatial=mesh)
    with pytest.raises(NotImplementedError, match="fused"):
        net.downs[1].res_block(torch.zeros(1, 16, 16, 8), None, spatial=mesh)
    with pytest.raises(ValueError, match="need 2 ranks"):
        pmesh.dmgasr_mesh(1, 2, device="cpu")


def test_one_rank_mesh_is_single_device(case):
    """A (1, 1) mesh in a single process is the single-device forward."""
    mesh = pmesh.dmgasr_mesh(1, 1, device="cpu")
    net = load_state_dict(UNet(**UNET_KW).eval(), case["unet_sd"])
    x, t = _t(case["unet_x"]), _t(case["unet_t"])
    with torch.no_grad():
        torch.testing.assert_close(net(x, t, spatial=mesh), net(x, t), rtol=TOL, atol=TOL)
