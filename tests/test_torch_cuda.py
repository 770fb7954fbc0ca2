"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: skipped where there is no GPU. Run on a GPU machine with
``python -m pytest --noconftest -q tests/test_torch_cuda.py`` (the
repository's conftest configures JAX, which the GPU machine need not
have; these tests import only torch and the port).

Tolerance: the kernel and the plain version see the same bf16 weights
and, for bf16 input, bf16 activations (for f32 input, the kernel's hi +
lo pair against the plain version's f32, 2^-17 apart), so they differ
only by f32 summation order and by a rare one-ulp flip of a bf16-rounded
activation (|w| * 2^-8 * |a| on one tap):
atol = rtol = 1e-2 on outputs, 1e-3 relative to the largest moment on
the per-row stats. The flash kernel and its plain version also share bf16
operands (q * scale, k, v, p); they differ by f32 summation order, the
kernel's ex2.approx against exp, and so a rare one-ulp flip of a bf16 p:
atol 1e-3, rtol 1e-2. The outputs are weighted means of unit-variance
values, typically 0.01-0.1 here, and the kernel has differed by at most
about 1e-4 at the main path's shape on an H100. The peaked softmax,
whose outputs are near 1, keeps atol 1e-2 (see its docstring). The
blocked dot's int8 sums are exact int32 and are held bit for bit; its
bf16 sums are f32 in another order than the plain version's float64,
on outputs of about sqrt(K) = 14-24: atol 1e-3, rtol 1e-4. The up path's
kernel is held to cuDNN's f32 transposed conv (TF32 off), to its plain
version and to the JAX package's output kept in a golden, elementwise
within 2e-5 of sum |x| |w| over each output's taps:
its bf16 hi + lo products leave out terms below 3 x 2^-18 (1.1e-5) of it,
and its f32 sums run in another order (about 1e-6; the largest measured on
an H100 was 2.4e-6). The split attention kernel and its plain version
carry q * scale, k, v and p as bf16 hi + lo pairs alike; each is within
2^-16 (1 + 2 A_i) W_id of the exact function (A_i the row's largest
sum |q||k| * scale, W_id = sum_j p_ij |v_jd|; kernels/split_attention.py:split_bound
derives it), so they are held to that bound of each other: they differ by
f32 summation order and the kernel's ex2.approx (3.7e-6 at most at the
r3 shape on an H100, 1.2e-7 of the bound). Against the JAX package's
output (tests/golden/split_attention_golden.npz), each side within that
bound of the exact function, the kernel is held to twice it.
"""

import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu_torch.kernels import (attention, blocked_dot, flash_attention, fused_conv,
                                          split_attention, up2_conv)
from hsi_dmgasr_tpu_torch.ops import fused_up
from hsi_dmgasr_tpu_torch.parallel import spatial
from hsi_dmgasr_tpu_torch.tools import microbench_int8

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(b, h, w, c, c2, cout, extras, dtype, dev, seed=0):
    rng = np.random.RandomState(seed)
    ct = c + c2

    def t(*shape, s=1.0, off=0.0):
        return torch.tensor(rng.randn(*shape) * s + off, dtype=torch.float32, device=dev)

    kw = dict(num_groups=8, emit_stats="stats" in extras)
    x = t(b, h, w, c).to(dtype)
    kw["x2"] = t(b, h, w, c2).to(dtype) if c2 else None
    gs, gb = t(ct, s=0.2, off=1.0), t(ct, s=0.1)
    kernel = t(3, 3, ct, cout, s=1.0 / np.sqrt(9 * ct))
    bias = t(cout, s=0.1)
    if "tb" in extras:
        kw["time_bias"] = t(b, cout)
    if "res" in extras:
        kw["residual"] = t(b, h, w, cout).to(dtype)
    if "stats_in" in extras:
        xf = x.float()
        kw["stats_in"] = torch.stack([xf.sum(2), (xf * xf).sum(2)], 2)
    if "proj" in extras:
        kw["res_kernel"] = t(1, 1, ct, cout, s=0.2)
        kw["res_bias"] = t(cout, s=0.1)
    return (x, gs, gb, kernel, bias), kw


def _compare(got, want, has_stats):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype
        if has_stats and i == 1:
            scale = w.abs().max().item()
            torch.testing.assert_close(g, w, atol=1e-3 * scale, rtol=0)
        else:
            torch.testing.assert_close(g.float(), w.float(), atol=1e-2, rtol=1e-2)


CASES = [
    ((2, 8, 16, 32, 0, 32), "none"),
    ((2, 8, 130, 64, 0, 64), "tb+res"),         # W > 128: two masked segments
    ((1, 6, 32, 64, 32, 64), "stats+proj"),     # x2, R=4 rows, ragged H
    ((2, 5, 24, 32, 0, 3), "stats_in+stats"),   # Cout=3 masked N tile
    ((1, 8, 16, 32, 0, 64), "stats+tb"),        # warp spans two rows
    ((2, 4, 32, 96, 0, 128), "tb+proj+stats"),  # two N tiles, 3 K chunks
    ((1, 4, 128, 64, 64, 64), "res+stats+proj"),
    ((1, 6, 40, 64, 0, 320), "tb+stats"),       # 128-wide N tiles, ragged third
    ((1, 5, 260, 64, 0, 64), "tb+res+stats"),   # two rows per CTA, odd H, W > 128
    ((2, 7, 140, 64, 0, 3), "stats_in+stats"),  # thin Cout=3 tile, two W segments
    ((1, 4, 16, 1024, 0, 128), "tb+proj+stats"),  # a 32-chunk K loop
    ((1, 3, 136, 128, 64, 64), "tb+stats+proj"),  # the 512^2 up-block source split
    ((1, 4, 24, 256, 128, 128), "tb+stats+proj"),  # x2 at Cout >= 128 (fuse_skip=True)
    ((9, 8, 8, 512, 0, 512), "res+stats_in+stats"),  # W = 8: a 128^2 cube's deepest level
    ((9, 8, 8, 1024, 0, 512), "tb+stats+proj"),      # its up-path block1, skip concatenated
    # the main path's batch sizes beside 1 and 9: B=5 (a data-parallel
    # rank's latents) and B=36 (four cubes unchunked)
    ((5, 16, 64, 64, 64, 64), "tb+res+stats+proj"),  # Tall, x2
    ((5, 8, 32, 256, 0, 256), "stats_in+stats"),     # Wide, two N tiles
    ((36, 4, 32, 128, 0, 128), "tb+stats"),          # Wide
    ((36, 4, 64, 64, 0, 64), "res+stats_in+stats"),  # Tall
    ((36, 8, 16, 64, 0, 3), "stats_in"),             # thin
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,extras", CASES)
def test_kernel_matches_plain(dev, shape, extras, dtype):
    args, kw = _case(*shape, extras, dtype, dev)
    want = fused_conv.gn_swish_conv3x3_plain(*args, **kw)
    n0 = fused_conv.LAUNCHES
    got = fused_conv.gn_swish_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert fused_conv.LAUNCHES == n0 + 1
    _compare(got, want, kw["emit_stats"])


# every operand in bf16, as the bf16 UNet hands them over: GroupNorm and
# conv params, a bf16 time bias from the noise Linear, bf16 residual and x2
BF16_CASES = [
    ((2, 8, 48, 64, 64, 64), "tb+stats+proj"),        # up-path block1, skip riding
    ((1, 5, 24, 64, 64, 128), "tb+res+stats"),        # x2 and a residual, ct == Cout
    ((1, 4, 24, 256, 128, 128), "tb+stats+proj"),     # x2 at Cout >= 128
    ((2, 6, 32, 128, 0, 128), "res+stats_in+stats"),  # block2
]


@pytest.mark.parametrize("shape,extras", BF16_CASES)
def test_kernel_bf16_operands_match_plain(dev, shape, extras):
    args, kw = _case(*shape, extras, torch.bfloat16, dev)
    args = tuple(a.to(torch.bfloat16) for a in args)
    for name in ("time_bias", "res_kernel", "res_bias"):
        if name in kw:
            kw[name] = kw[name].to(torch.bfloat16)
    want = fused_conv.gn_swish_conv3x3_plain(*args, **kw)
    n0 = fused_conv.LAUNCHES
    got = fused_conv.gn_swish_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert fused_conv.LAUNCHES == n0 + 1
    _compare(got, want, kw["emit_stats"])


# H-shard launches: the shard's neighbours' raw boundary rows (halo, and
# halo2 for x2) at a first, middle or last shard of three. A one-process
# mesh gives the edge flags; its moments are the shard's own, the same
# for the kernel and the plain version.
HALO_CASES = [
    ((2, 8, 16, 32, 0, 32), "tb"),
    ((1, 6, 40, 64, 64, 64), "stats+proj"),     # x2 with halo2, ragged last tile
    ((2, 5, 24, 64, 0, 3), "stats_in+stats"),   # the thin Cout=3 tile
    ((1, 4, 130, 64, 0, 128), "res+stats"),     # two W segments, 128-wide N
    ((1, 8, 8, 512, 0, 512), "tb+stats"),       # a deep level: W = 8
]


def _halo(args, kw, dtype, dev, seed=1):
    x, x2 = args[0], kw["x2"]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rows(src):
        b, _, w, c = src.shape
        return tuple(torch.randn((b, 1, w, c), generator=gen, device=dev).to(dtype)
                     for _ in range(2))

    return rows(x), rows(x2) if x2 is not None else None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("position", [0, 1, 2])
@pytest.mark.parametrize("shape,extras", HALO_CASES)
def test_kernel_with_halo_matches_plain(dev, shape, extras, dtype, position):
    from hsi_dmgasr_tpu_torch.parallel.mesh import Mesh

    args, kw = _case(*shape, extras, dtype, dev)
    kw["halo"], kw["halo2"] = _halo(args, kw, dtype, dev)
    kw["mesh"] = Mesh(n_data=1, n_space=3, data_idx=0, space_idx=position, device=dev)
    want = fused_conv.gn_swish_conv3x3_plain(*args, **kw)
    n0 = fused_conv.LAUNCHES
    got = fused_conv.gn_swish_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert fused_conv.LAUNCHES == n0 + 1
    _compare(got, want, kw["emit_stats"])


@pytest.mark.parametrize("shape,extras", HALO_CASES[:2])
def test_kernel_halo_at_both_edges_reads_no_halo(dev, shape, extras):
    """One shard of one: both flags mark a true edge, so the halo rows are
    never read and the output is the launch without halo, bit for bit."""
    from hsi_dmgasr_tpu_torch.parallel.mesh import Mesh

    args, kw = _case(*shape, extras, torch.float32, dev)
    want = fused_conv.gn_swish_conv3x3(*args, **kw)
    kw["halo"], kw["halo2"] = _halo(args, kw, torch.float32, dev)
    kw["mesh"] = Mesh(n_data=1, n_space=1, data_idx=0, space_idx=0, device=dev)
    got = fused_conv.gn_swish_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    assert torch.equal(got[0], want[0])


def test_kernel_rejects_unaligned_channels(dev):
    args, kw = _case(1, 4, 8, 16, 0, 16, "none", torch.float32, dev)
    with pytest.raises(ValueError, match="multiples"):
        fused_conv.gn_swish_conv3x3(*args, **kw)


@pytest.mark.parametrize("cout,route", [(3, "thin"), (8, "thin"), (16, "wgmma"),
                                        (64, "wgmma"), (256, "wgmma")])
def test_launches_counted_by_route(dev, cout, route):
    args, kw = _case(1, 4, 16, 64, 0, cout, "none", torch.float32, dev)
    before = dict(fused_conv.LAUNCHES_BY_ROUTE)
    fused_conv.gn_swish_conv3x3(*args, **kw)
    torch.cuda.synchronize()
    after = fused_conv.LAUNCHES_BY_ROUTE
    assert after[route] == before[route] + 1
    assert sum(after.values()) == sum(before.values()) + 1


FLASH_CASES = [
    (2, 300, 1, 128),   # ragged S: a masked last K tile and unstored Q rows
    (1, 200, 2, 256),   # multi-head
    (1, 130, 1, 384),   # the f32-staged body: two column slices
    (2, 70, 1, 512),
    (1, 64, 3, 128),    # one K/V tile exactly
    (1, 8200, 1, 256),  # S a multiple of neither 64 nor 128: a ragged last tile
    (1, 40, 2, 128),    # S < 64: one partial K/V tile, one partial Q tile
    (2, 300, 3, 256),   # B*H = 6 over strided views with H > 1
    (1, 128, 1, 256),   # one Q tile and two K/V tiles exactly
]


def _qkv(b, s, h, d, dev, seed=0, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, h, 3 * d), generator=gen, device=dev).to(dtype)
    return qkv.split(d, dim=-1)


@pytest.mark.parametrize("shape", FLASH_CASES)
def test_flash_matches_plain(dev, shape):
    q, k, v = _qkv(*shape, dev)
    scale = 1.0 / np.sqrt(shape[2] * shape[3])
    want = flash_attention.flash_attention_plain(q, k, v, scale)
    n0 = flash_attention.LAUNCHES
    got = flash_attention.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == n0 + 1
    assert got.shape == want.shape and got.dtype == want.dtype and got.is_contiguous()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-2)


# bf16 q, k, v (the bf16 UNet's qkv split): the prepass copies k and v and
# rounds q * bf16(scale) once; the output is rounded once to bf16, so a
# one-ulp flip of it (2^-8 relative) stays inside rtol 1e-2
FLASH_BF16_CASES = [
    (2, 300, 1, 128),   # ragged S
    (1, 8200, 1, 256),  # the wgmma body past the gate, a ragged last tile
    (1, 130, 1, 384),   # the staged mma.sync body, bf16 tiles copied
    (2, 70, 1, 512),
]


@pytest.mark.parametrize("shape", FLASH_BF16_CASES)
def test_flash_bf16_matches_plain(dev, shape):
    q, k, v = _qkv(*shape, dev, dtype=torch.bfloat16)
    scale = 1.0 / np.sqrt(shape[2] * shape[3])
    want = flash_attention.flash_attention_plain(q, k, v, scale)
    n0 = flash_attention.LAUNCHES
    got = flash_attention.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == n0 + 1
    assert got.dtype == torch.bfloat16 == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=1e-2)


@pytest.mark.parametrize("d", [128, 256])
def test_flash_peaked_softmax(dev, d):
    """Large logits: the running max moves across tiles and most p round
    to zero. The outputs are then single rows of v, |out| about 0.8, and
    a one-ulp bf16 flip of a p near 1/2 moves one by up to 2^-9 |v|
    (2.9e-3 on an H100): atol = rtol = 1e-2."""
    q, k, v = _qkv(1, 500, 1, d, dev, seed=1)
    want = flash_attention.flash_attention_plain(q * 8, k, v, 1.0)
    got = flash_attention.flash_attention(q * 8, k, v, 1.0)
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)


def test_flash_rejects_unaligned_rows(dev):
    qkv = torch.zeros((1, 64, 1, 3 * 128 + 1), device=dev)
    q, k, v = qkv[..., 1:].split(128, dim=-1)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention.flash_attention(q, k, v, 0.1)


def test_gate_launches_the_kernel_on_the_card(dev):
    q, k, v = _qkv(1, 8192, 1, 128, dev, seed=2)
    n0 = flash_attention.LAUNCHES
    out = attention.spatial_attention(q, k, v, 1.0 / np.sqrt(128))
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == n0 + 1 and out.shape == (1, 8192, 128)
    q, k, v = _qkv(1, 1024, 1, 512, dev, seed=3)
    attention.spatial_attention(q, k, v, 1.0 / np.sqrt(512))
    assert flash_attention.LAUNCHES == n0 + 1


# the split kernel: (B, S, H, D)
SPLIT_CASES = [
    (9, 4096, 1, 512),   # configs/pavia_x4_r3.json: the 64^2 level of a 512^2 latent
    (9, 1024, 1, 512),   # the mid block at 32^2
    (2, 1000, 1, 512),   # S ragged against every tile
    (1, 300, 3, 64),     # H > 1 over strided views
    (1, 256, 1, 512),    # configs/sr_sr3_16_128.json at 16^2, B=1
    (1, 16, 1, 512),     # the shortest sequence the router sends
]


@pytest.mark.parametrize("shape", SPLIT_CASES)
def test_split_attention_matches_plain(dev, shape):
    q, k, v = _qkv(*shape, dev, seed=shape[1])
    scale = 1.0 / np.sqrt(shape[2] * shape[3])
    want = split_attention.split_attention_plain(q, k, v, scale)
    n0 = split_attention.LAUNCHES
    got = split_attention.split_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert split_attention.LAUNCHES == n0 + 1
    assert got.shape == want.shape and got.dtype == torch.float32 and got.is_contiguous()
    bound = split_attention.split_bound(q, k, v, scale)
    assert bool(((got.double() - want.double()).abs() <= 2.0 ** -16 * bound).all())


@pytest.mark.parametrize("name", ["d512", "heads"])
def test_split_kernel_matches_the_jax_package(dev, name):
    """The kernel against the JAX package's _xla_attention of the same q, k
    and v: its output is kept in tests/golden/split_attention_golden.npz,
    made on the CPU, where tests/test_torch_split_attention.py holds it to
    the JAX package. Each is within 2^-16 (1 + 2 A) W of float64."""
    import os

    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "split_attention_golden.npz"))
    qkv, want = (torch.from_numpy(g[f"{name}.{k}"]).to(dev) for k in ("qkv", "out"))
    b, s, h, d = want.shape
    q, k, v = qkv.split(d, dim=-1)
    scale = 1.0 / np.sqrt(h * d)
    n0 = split_attention.LAUNCHES
    got = split_attention.split_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert split_attention.LAUNCHES == n0 + 1
    bound = split_attention.split_bound(q, k, v, scale)
    assert bool(((got.double() - want.double()).abs() <= 2.0 ** -15 * bound).all())


def test_gate_copies_layouts_the_kernel_does_not_read(dev):
    """q with D not unit-stride still takes the kernel, on a copy."""
    q, k, v = _qkv(2, 300, 1, 128, dev, seed=6)
    qt = q.permute(3, 2, 1, 0).contiguous().permute(3, 2, 1, 0)
    assert qt.stride(-1) != 1 and torch.equal(qt, q)
    n0 = split_attention.LAUNCHES
    got = attention.spatial_attention(qt, k, v, 0.08)
    torch.cuda.synchronize()
    assert split_attention.LAUNCHES == n0 + 1
    want = split_attention.split_attention_plain(q, k, v, 0.08).reshape(got.shape)
    bound = split_attention.split_bound(q, k, v, 0.08).reshape(got.shape)
    assert bool(((got.double() - want.double()).abs() <= 2.0 ** -16 * bound).all())


def test_gate_takes_the_split_kernel_on_the_card(dev):
    """f32 below the flash gate: the split kernel, unless autograd records
    a graph through the call; bf16 keeps the einsum route."""
    q, k, v = _qkv(1, 1024, 1, 512, dev, seed=5)
    n0, routes = split_attention.LAUNCHES, dict(attention.LAUNCHES_BY_ROUTE)
    out = attention.spatial_attention(q, k, v, 1.0 / np.sqrt(512))
    torch.cuda.synchronize()
    assert split_attention.LAUNCHES == n0 + 1 and out.shape == (1, 1024, 512)
    attention.spatial_attention(q.detach().requires_grad_(True), k, v, 0.05)
    attention.spatial_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.05)
    assert split_attention.LAUNCHES == n0 + 1
    assert {r: n - routes[r] for r, n in attention.LAUNCHES_BY_ROUTE.items()} == \
        {"flash": 0, "split": 1, "einsum": 2}


# the int8 probe's cases (M, K, N, bm, bn); a ragged K tail of one MMA step
# and edge tiles that the kernel masks (M = 96, N = 200); K of one MMA step;
# K deeper than the ring, its last 128-byte box partial; N = 7, whose 4-byte
# output rows are not 16-byte aligned; M = 200 over several row tiles, the
# last partial; a wide N
DOT_CASES = [c[1:] for c in microbench_int8.CASES] + [
    (96, 96, 200, 32, 8),
    (128, 32, 64, 128, 64),
    (256, 1056, 128, 256, 128),
    (64, 64, 7, 64, 7),
    (200, 128, 128, 8, 128),
    (512, 512, 1024, 512, 1024),
]


def _dot_operands(m, k, n, dtype, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int8:
        return (microbench_int8.rand_int8(gen, (m, k)), microbench_int8.rand_int8(gen, (k, n)))
    return (torch.randn((m, k), generator=gen, device=dev).to(dtype),
            torch.randn((k, n), generator=gen, device=dev).to(dtype))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,bm,bn", DOT_CASES)
def test_blocked_dot_matches_plain(dev, m, k, n, bm, bn, dtype):
    x, w = _dot_operands(m, k, n, dtype, dev)
    want = blocked_dot.blocked_dot_plain(x, w)
    n0 = blocked_dot.LAUNCHES
    got = blocked_dot.blocked_dot(x, blocked_dot.pack_dot_weight(w), bm, bn)
    torch.cuda.synchronize()
    assert blocked_dot.LAUNCHES == n0 + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.int8:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_captured_chain_matches_eager(dev, dtype):
    """Three links captured in a CUDA graph and replayed against the same
    links run eagerly: one kernel, so the same bits."""
    _, m, k, n, bm, bn = microbench_int8.CASES[1]   # K > N: the zero-pad link
    x, w = _dot_operands(m, k, n, dtype, dev, seed=1)
    dot = microbench_int8.kernel_dot(w, bm, bn)
    eager = microbench_int8.run_chain(dot, x, 3)
    microbench_int8.warm_up(dot, x)
    n0 = blocked_dot.LAUNCHES
    graph, static_x, out = microbench_int8.capture_chain(dot, x, 3)
    assert blocked_dot.LAUNCHES == n0 + 3
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2, _ = _dot_operands(m, k, n, dtype, dev, seed=2)
    static_x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, microbench_int8.run_chain(dot, x2, 3))


# ------------------------------------------------------- the baseline zoo
# Each baseline at its golden's width (tests/golden/*_forward_golden.npz,
# the reference state_dict loaded strictly) on the card against the same
# forward on the CPU, TF32 off: cuDNN's f32 convolutions in another order,
# at the JAX tests' atol 2e-5, rtol 1e-4 (GDRRN 5e-5); no kernel of the
# port is launched.

BASELINE_GOLDENS = ["sspsr", "gelin", "mcnet", "edsr", "gdrrn", "cegatsr", "gan3d_g", "gan3d_d"]


def _baseline(name):
    """(model, inputs as NHWC tensors) of a golden."""
    import os

    from hsi_dmgasr_tpu_torch.io.convert_torch import load_state_dict
    from hsi_dmgasr_tpu_torch.models import baselines as pb

    file = "gan3d" if name.startswith("gan3d") else name
    g = np.load(os.path.join(os.path.dirname(__file__), "golden", f"{file}_forward_golden.npz"))
    prefix = {"gan3d_g": "gsd::", "gan3d_d": "dsd::"}.get(name, "sd::")
    sd = {k.split("::", 1)[1]: g[k] for k in g.files if k.startswith(prefix)}
    nhwc = lambda a: torch.from_numpy(np.moveaxis(a, 1, -1).copy())  # noqa: E731
    make = {"sspsr": lambda: pb.SSPSR(8, 2, 31, n_blocks=3, n_feats=16, n_scale=4),
            "gelin": lambda: pb.GELIN(16, 31, n_subs=8, n_ovls=2, blocks=2, scale=4),
            "mcnet": lambda: pb.MCNet(4, 31, 8), "edsr": lambda: pb.EDSR(2, 16, 31),
            "gdrrn": lambda: pb.GDRNN(31, 4),
            "cegatsr": lambda: pb.CEGATSR(8, 2, 31, n_blocks=1, out_feats=16, n_scale=4),
            "gan3d_g": lambda: pb.GAN3DGenerator(31), "gan3d_d": pb.GAN3DDiscriminator}
    model = load_state_dict(make[name](), sd).eval()
    if name == "gan3d_g":
        return model, (nhwc(g["g_x"][:, 0]),)
    if name == "gan3d_d":
        return model, (nhwc(g["d_x"][:, 0]),)
    x = nhwc(g["x"])
    if name == "sspsr":
        return model, (x, x)
    return model, (x, nhwc(g["lms"])) if "lms" in g.files else (x,)


@pytest.mark.parametrize("name", BASELINE_GOLDENS)
def test_baseline_forward_on_the_card_matches_the_cpu(dev, name):
    model, args = _baseline(name)
    launches = (fused_conv.LAUNCHES, flash_attention.LAUNCHES, blocked_dot.LAUNCHES)
    with torch.no_grad():
        want = model(*args)
        got = model.to(dev)(*(a.to(dev) for a in args)).cpu()
    assert (fused_conv.LAUNCHES, flash_attention.LAUNCHES, blocked_dot.LAUNCHES) == launches
    torch.testing.assert_close(got, want, atol=5e-5 if name == "gdrrn" else 2e-5, rtol=1e-4)


# --- DAQ quantization, the refiners, the thin Block and the data-parallel
# chain on the card. None launches a kernel of the port: each is held to the
# CPU in f64, where no quantization statistic lands on a rounding boundary
# by chance (1e-9 relative to the largest |value|; the codebook's indices
# equal).


def _f64_both(make, *inputs, train=False):
    torch.manual_seed(0)
    model = make()
    sd = model.state_dict()
    outs = []
    for d in ("cpu", "cuda"):
        m = make().to(d, torch.float64).train(train)
        m.load_state_dict(sd)
        with torch.no_grad():
            outs.append(m(*(a.to(d, torch.float64) if a.is_floating_point() else a.to(d)
                            for a in inputs)))
    return outs


@pytest.mark.parametrize("kind", ["res", "ssb", "attn"])
@pytest.mark.parametrize("bits", [4, 8])
def test_daq_block_on_the_card_matches_the_cpu(dev, kind, bits):
    from hsi_dmgasr_tpu_torch.ops import quantize

    make = {"res": lambda: quantize.ResBlockDAQ(16, a_bit=bits, w_bit=bits),
            "ssb": lambda: quantize.SSBDAQ(16, a_bit=bits, w_bit=bits),
            "attn": lambda: quantize.ResAttentionBlockDAQ(16, a_bit=bits, w_bit=bits, qq_bit=8)}
    x = torch.randn((2, 24, 20, 16), generator=torch.Generator().manual_seed(bits))
    cpu, card = _f64_both(make[kind], x)
    assert (card.cpu() - cpu).abs().max() <= 1e-9 * cpu.abs().max()


def test_refiners_on_the_card_match_the_cpu(dev):
    from hsi_dmgasr_tpu_torch.models import refiners

    g = torch.Generator().manual_seed(3)
    x = torch.rand((2, 32, 32, 31), generator=g)
    for make, args, train in ((lambda: refiners.AttentionNet(31, 8), (x,), True),
                              (lambda: refiners.post_unet(31, 31, image_size=32),
                               (x, torch.tensor([0, 5], dtype=torch.int32)), True)):
        cpu, card = _f64_both(make, *args, train=train)
        assert (card.cpu() - cpu).abs().max() <= 1e-9 * cpu.abs().max()
    z = torch.randn((2, 4, 4, 64), generator=g)
    (zq_cpu, idx_cpu, loss_cpu), (zq, idx, loss) = _f64_both(lambda: refiners.Codebook(256, 64), z)
    assert torch.equal(idx.cpu(), idx_cpu)
    assert (zq.cpu() - zq_cpu).abs().max() <= 1e-12 and abs(loss.item() - loss_cpu.item()) < 1e-12


def test_thin_block_on_the_card_matches_the_cpu(dev):
    g = torch.Generator().manual_seed(4)
    args = [torch.randn((2, 16, 16, 64), generator=g), torch.rand(64, generator=g) + 0.5,
            0.1 * torch.randn(64, generator=g), torch.randn((3, 3, 64, 3), generator=g) / 24,
            0.1 * torch.randn(3, generator=g)]
    cpu = fused_conv.gn_swish_conv3x3_thin(*args, num_groups=32)
    card = fused_conv.gn_swish_conv3x3_thin(*(a.to(dev) for a in args), num_groups=32)
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------- the up path kernel

UP2_TOL = 2e-5
# (H = W, C, Cout) of the UNet's four up levels, and odd shapes, Cout != C
UP2_LEVELS = [(32, 512, 512), (64, 512, 512), (128, 256, 256), (256, 128, 128)]
UP2_ODD = [(1, 5, 7, 32, 64), (2, 9, 33, 64, 128), (1, 3, 70, 32, 36), (2, 17, 40, 96, 200)]


def _up2_case(b, h, w, c, cout, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, h, w, c), generator=g, device=dev)
    kernel = torch.randn((3, 3, c, cout), generator=g, device=dev) / np.sqrt(9 * c)
    bias = torch.randn((cout,), generator=g, device=dev)
    return x, kernel, bias


def _up2_within(got, want, x, kernel):
    scale = fused_up.up2_conv3x3_transpose(x.abs(), kernel.abs())
    assert got.shape == want.shape and got.dtype == want.dtype
    assert ((got - want).abs() <= UP2_TOL * scale).all()


def _up2_kernel_call(x, kernel, bias):
    before = dict(up2_conv.LAUNCHES_BY_ROUTE)
    got = fused_up.up2_conv3x3(x, kernel, bias)
    assert up2_conv.LAUNCHES_BY_ROUTE == {"kernel": before["kernel"] + 1,
                                          "transpose": before["transpose"]}
    return got


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b", [9, 1])
@pytest.mark.parametrize("level", UP2_LEVELS)
def test_up2_kernel_matches_cudnn_f32(dev, level, b, with_bias):
    res, c, cout = level
    x, kernel, bias = _up2_case(b, res, res, c, cout, dev)
    bias = bias if with_bias else None
    got = _up2_kernel_call(x, kernel, bias)
    _up2_within(got, fused_up.up2_conv3x3_transpose(x, kernel, bias), x, kernel)


@pytest.mark.parametrize("shape", UP2_ODD)
def test_up2_kernel_at_odd_shapes_matches_plain_and_cudnn(dev, shape):
    x, kernel, bias = _up2_case(*shape, dev, seed=1)
    got = _up2_kernel_call(x, kernel, bias)
    _up2_within(got, fused_up.up2_conv3x3_transpose(x, kernel, bias), x, kernel)
    _up2_within(got, fused_up.up2_conv3x3_parity(x, kernel, bias), x, kernel)


def test_up2_bf16_cpu_and_spatial_keep_the_transpose_route(dev, monkeypatch):
    x, kernel, bias = _up2_case(1, 8, 8, 32, 32, dev)
    before = dict(up2_conv.LAUNCHES_BY_ROUTE)
    half = [t.bfloat16() for t in (x, kernel, bias)]
    got = fused_up.up2_conv3x3(*half)
    # cuDNN may take another algorithm on the next call: bf16's 2^-8 apart
    torch.testing.assert_close(got.float(), fused_up.up2_conv3x3_transpose(*half).float(),
                               atol=1e-2, rtol=1e-2)
    assert got.dtype == torch.bfloat16
    cpu = [t.cpu() for t in (x, kernel, bias)]
    assert torch.equal(fused_up.up2_conv3x3(*cpu), fused_up.up2_conv3x3_transpose(*cpu))
    assert up2_conv.LAUNCHES_BY_ROUTE == {"kernel": before["kernel"],
                                          "transpose": before["transpose"] + 2}
    # an H-shard at both true edges: its halo rows are zeros
    monkeypatch.setattr(spatial, "_extended",
                        lambda t, mesh: torch.nn.functional.pad(t, (0, 0, 0, 0, 1, 1)))
    got = spatial.up2_conv3x3_spatial(x, kernel, bias, mesh=None)
    assert up2_conv.LAUNCHES_BY_ROUTE["kernel"] == before["kernel"]
    _up2_within(got, fused_up.up2_conv3x3_transpose(x, kernel, bias), x, kernel)


@pytest.mark.parametrize("c,cout", [(48, 32), (64, 30)])
def test_up2_channels_the_tiles_do_not_take(dev, c, cout):
    x, kernel, bias = _up2_case(1, 8, 8, c, cout, dev)
    before = dict(up2_conv.LAUNCHES_BY_ROUTE)
    got = fused_up.up2_conv3x3(x, kernel, bias)  # the router falls back
    assert up2_conv.LAUNCHES_BY_ROUTE == {"kernel": before["kernel"],
                                          "transpose": before["transpose"] + 1}
    # cuDNN's f32 transposed conv, which may take another algorithm on the next call
    _up2_within(got, fused_up.up2_conv3x3_transpose(x, kernel, bias), x, kernel)
    with pytest.raises(ValueError):  # the wrapper refuses
        up2_conv.up2_conv3x3(x, up2_conv.pack_up2(fused_up.parity_taps(kernel)), bias)



@pytest.mark.parametrize("name", ["nobias", "odd"])
def test_up2_kernel_matches_the_jax_package(dev, name):
    """The kernel against the JAX package's up2_conv3x3 of the same x, kernel
    and bias: its output is kept in tests/golden/up2_conv3x3_golden.npz,
    made on the CPU, where tests/test_torch_fused_up.py holds it to the JAX
    package."""
    import os

    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "up2_conv3x3_golden.npz"))
    x, kernel = (torch.from_numpy(g[f"{name}.{k}"]).to(dev) for k in ("x", "kernel"))
    bias = torch.from_numpy(g[f"{name}.bias"]).to(dev) if f"{name}.bias" in g.files else None
    got = _up2_kernel_call(x, kernel, bias)
    _up2_within(got, torch.from_numpy(g[f"{name}.out"]).to(dev), x, kernel)
