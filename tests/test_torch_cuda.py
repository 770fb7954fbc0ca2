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
on outputs of about sqrt(K) = 14-24: atol 1e-3, rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu_torch.kernels import attention, blocked_dot, flash_attention, fused_conv
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


def test_kernel_rejects_unaligned_channels(dev):
    args, kw = _case(1, 4, 8, 16, 0, 16, "none", torch.float32, dev)
    with pytest.raises(ValueError, match="multiples"):
        fused_conv.gn_swish_conv3x3(*args, **kw)


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
