"""The port's fused GroupNorm -> swish -> conv3x3 against the JAX kernel.

Same numpy inputs through ``hsi_dmgasr_tpu.kernels.fused_conv`` (Pallas
in interpret mode, as tests/test_fused_conv.py runs it on the CPU) and
through ``hsi_dmgasr_tpu_torch.kernels.fused_conv`` on CPU tensors, where
the wrapper runs its plain PyTorch version.

Tolerance: the JAX package's own for the fused block, atol = rtol = 0.05
on outputs and rtol 2e-2 on the per-row stats
(tests/test_fused_conv.py:66-67, 105-108): both sides round the weights
to bf16 and accumulate in f32, in different orders; the JAX kernel also
rounds x, the activation and the residual to bf16, which the port's f32
path keeps in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.kernels import fused_conv as jfc
from hsi_dmgasr_tpu_torch.kernels import fused_conv as tfc

ATOL = RTOL = 0.05
STATS_RTOL = 2e-2


def _inputs(b, h, w, c, c2, cout, extras, seed=0):
    rng = np.random.RandomState(seed)
    ct = c + c2
    d = dict(
        x=rng.randn(b, h, w, c).astype(np.float32),
        gn_scale=rng.rand(ct).astype(np.float32) + 0.5,
        gn_bias=rng.randn(ct).astype(np.float32) * 0.1,
        kernel=(rng.randn(3, 3, ct, cout) / np.sqrt(9 * ct)).astype(np.float32),
        bias=rng.randn(cout).astype(np.float32) * 0.1,
    )
    if c2:
        d["x2"] = rng.randn(b, h, w, c2).astype(np.float32)
    if "tb" in extras:
        d["time_bias"] = rng.randn(b, cout).astype(np.float32)
    if "res" in extras:
        d["residual"] = rng.randn(b, h, w, cout).astype(np.float32)
    if "proj" in extras:
        d["res_kernel"] = rng.randn(1, 1, ct, cout).astype(np.float32) * 0.2
        d["res_bias"] = rng.randn(cout).astype(np.float32) * 0.1
    if "stats_in" in extras:
        xf = d["x"].astype(np.float64)
        d["stats_in"] = np.stack([xf.sum(2), (xf ** 2).sum(2)], 2).astype(np.float32)
    return d


def _both(d, **kw):
    want = jfc.gn_swish_conv3x3(**{k: jnp.asarray(v) for k, v in d.items()},
                                interpret=True, **kw)
    got = tfc.gn_swish_conv3x3(**{k: torch.tensor(v) for k, v in d.items()}, **kw)
    want = [np.asarray(v, np.float32) for v in (want if isinstance(want, tuple) else (want,))]
    got = [t.float().numpy() for t in (got if isinstance(got, tuple) else (got,))]
    assert [g.shape for g in got] == [w.shape for w in want]
    return got, want


def _check(got, want, emit_stats=False):
    for i, (g, w) in enumerate(zip(got, want)):
        if emit_stats and i == 1:
            np.testing.assert_allclose(g, w, rtol=STATS_RTOL, atol=STATS_RTOL * np.abs(w).max())
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,cout,extras", [
    ((2, 16, 16, 16), 16, "none"),
    ((1, 24, 16, 16), 32, "tb"),
    ((2, 8, 8, 16), 16, "tb+res"),
    ((1, 40, 24, 32), 16, "res"),
    ((1, 8, 8, 128), 16, "tb"),
    ((1, 16, 8, 32), 64, "tb"),
    ((1, 8, 8, 128), 64, "res"),
    ((1, 16, 8, 64), 64, "tb+res"),
    ((1, 8, 8, 64), 16, "none"),
])
def test_block_matches_jax(shape, cout, extras):
    b, h, w, c = shape
    _check(*_both(_inputs(b, h, w, c, 0, cout, extras), num_groups=8))


def test_two_sources_match_jax():
    _check(*_both(_inputs(2, 16, 16, 16, 8, 16, "tb"), num_groups=8))


def test_stats_chaining_matches_jax():
    d = _inputs(2, 16, 16, 16, 0, 16, "tb", seed=4)
    got, want = _both(d, num_groups=8, emit_stats=True)
    _check(got, want, emit_stats=True)
    # chain: the second block consumes the first's per-row moments
    d2 = _inputs(2, 16, 16, 16, 0, 16, "res", seed=5)
    d2["x"], d2["stats_in"] = want[0], want[1]
    _check(*_both(d2, num_groups=8, emit_stats=True), emit_stats=True)


def test_res_projection_with_x2_matches_jax():
    d = _inputs(1, 8, 16, 64, 64, 64, "tb+proj", seed=11)
    d["stats_in2"] = np.stack([d["x2"].sum(2), (d["x2"] ** 2).sum(2)], 2)
    got, want = _both(d, num_groups=8, emit_stats=True)
    assert len(got) == 3
    _check(got, want, emit_stats=True)


def test_thin_output_with_stats_in_matches_jax():
    d = _inputs(2, 8, 16, 64, 0, 3, "stats_in", seed=7)
    _check(*_both(d, num_groups=8))


def test_scale_shift_uses_raw_second_moment():
    """var = E[x^2] - mean^2 clamped at 0 (not mean((x - mean)^2)), from
    per-row partials: the same scale/shift as the JAX host side."""
    d = _inputs(2, 8, 8, 32, 0, 32, "none", seed=3)
    x = d["x"] + 3.0
    st = jfc._row_moments(jnp.asarray(x))
    s, s2 = jfc._reduce_row_stats(st, None)
    want = jfc._scale_shift(jnp.asarray(d["gn_scale"]), jnp.asarray(d["gn_bias"]),
                            s / 64, s2 / 64, 8, 1e-5)
    got = tfc.gn_scale_shift(torch.from_numpy(x), torch.from_numpy(d["gn_scale"]),
                             torch.from_numpy(d["gn_bias"]), num_groups=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_packed_layout():
    """pack_conv3x3 puts tap (dy, dx), input channel j*32+k and output n
    at wpack[j, 3*dy+dx, n, k] and the 1x1 res kernel at rpack[j, n, k],
    with no padding of Cout. The CUDA kernel indexes so."""
    rng = np.random.RandomState(0)
    kernel = torch.from_numpy(rng.randn(3, 3, 96, 70).astype(np.float32))
    rk = torch.from_numpy(rng.randn(1, 1, 96, 70).astype(np.float32))
    p = tfc.pack_conv3x3(kernel, rk)
    assert p.wpack.shape == (3, 9, 70, 32) and p.wpack.dtype == torch.bfloat16
    assert p.rpack.shape == (3, 70, 32)
    want = kernel.to(torch.bfloat16).reshape(9, 3, 32, 70).permute(1, 0, 3, 2)
    assert torch.equal(p.wpack, want)
    assert torch.equal(p.rpack, rk.to(torch.bfloat16).reshape(3, 32, 70).permute(0, 2, 1))
    assert (p.cin, p.cout) == (96, 70)


def test_cpu_tensors_take_the_plain_version():
    d = _inputs(1, 4, 4, 32, 0, 32, "none")
    n0, routes = tfc.LAUNCHES, dict(tfc.LAUNCHES_BY_ROUTE)
    out = tfc.gn_swish_conv3x3(**{k: torch.from_numpy(v) for k, v in d.items()})
    assert tfc.LAUNCHES == n0 and out.shape == (1, 4, 4, 32)
    assert tfc.LAUNCHES_BY_ROUTE == routes


# ------------------------------------------------ the kernel's routes by Cout


def _tiles():
    """{tile name: (kind, BN)} and the dispatch rules of csrc/fused_conv.cu,
    read from the source."""
    import re
    from pathlib import Path

    src = (Path(tfc.__file__).resolve().parent.parent / "csrc" / "fused_conv.cu").read_text()
    # WgTile<MF, BN, MAX_BW>; a SyncTile's BN is fixed in its struct
    sync_bn = int(re.search(r"struct SyncTile \{.*?BN = (\d+)", src, re.S).group(1))
    tiles = {name: (kind, int(args.split(",")[1]) if kind == "WgTile" else sync_bn)
             for name, kind, args in
             re.findall(r"using (\w+Tile) = (WgTile|SyncTile)<([^>]*)>;", src)}
    body = re.search(r"int dispatch\(const Params& p, cudaStream_t s\) \{(.*?)\n\}", src, re.S).group(1)
    rules = re.findall(r"(?:if \(p\.Cout <= (\w+)(?:<T>)?::BN\) )?"
                       r"return launch<T, (\w+)(?:<T>)?, RES>", body)
    return tiles, rules


def test_route_rule_is_the_kernels_dispatch():
    """THIN_COUT is the thin tile's BN, the dispatch's first rule; every
    other tile of the dispatch is a wgmma tile, and no Wide or Tall tile is
    left on mma.sync."""
    tiles, rules = _tiles()
    assert set(tiles) == {"WideTile", "TallTile", "ThinTile"}
    assert tiles["ThinTile"] == ("SyncTile", tfc.THIN_COUT)
    assert tiles["WideTile"][0] == tiles["TallTile"][0] == "WgTile"
    assert rules[0] == ("ThinTile", "ThinTile")
    assert [t for _, t in rules[1:]] == ["TallTile", "WideTile"]


@pytest.mark.parametrize("cout", [1, 3, 8, 9, 16, 32, 64, 65, 128, 256, 320, 512])
def test_route_of_each_cout(cout):
    """The Python rule picks the tile the C entry's dispatch picks."""
    tiles, rules = _tiles()
    tile = next(t for bound, t in rules if not bound or cout <= tiles[bound][1])
    assert tfc.route(cout) == ("thin" if tiles[tile][0] == "SyncTile" else "wgmma")
