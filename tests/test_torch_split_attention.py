"""The split kernel's plain version, the attention router and its counter,
and the two per-layer metrics that read them, on the CPU.

``split_attention_plain`` (the kernel's arithmetic: q * scale, k, v and p
as bf16 hi + lo pairs, three products each with f32 sums, a base-2
softmax in f32) is held to softmax(q k^T * scale) v in float64, and to the
JAX package's ``_xla_attention`` in f32. Tolerance, elementwise: 2^-16 of
``split_bound``'s (1 + 2 A_i) W_id, with A_i = max_j sum_d |q_id| |k_jd|
* scale and W_id = sum_j p_ij |v_jd| (its docstring derives it). The plain
version is also at least 16 times closer to float64 than the same
arithmetic on bf16 operands alone (the flash kernel's class), which the
bound, made for the worst case, does not tell apart.
"""

import math
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from hsi_dmgasr_tpu.kernels.attention import _xla_attention
from hsi_dmgasr_tpu_torch.kernels import attention
from hsi_dmgasr_tpu_torch.kernels import split_attention as sa
from portbench import run as harness
from portbench.trace import _describe

METRICS = Path(__file__).resolve().parents[1] / "portbench" / "metrics"


def _qkv(b, s, h, d, seed=0):
    """q, k, v as the UNet makes them: strided views of one qkv tensor."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, h, 3 * d).astype(np.float32)
    return qkv, [torch.tensor(qkv).split(d, dim=-1)[i] for i in range(3)]


def _exact(q, k, v, scale):
    """softmax(q k^T * scale) v in float64, (B, S, H, D), and the bound's
    (1 + 2 A) W in the same layout (``split_bound``)."""
    qd, kd, vd = (t.double().permute(0, 2, 1, 3) for t in (q, k, v))
    p = torch.softmax((qd * scale) @ kd.transpose(-1, -2), -1)
    return (p @ vd).permute(0, 2, 1, 3), sa.split_bound(q, k, v, scale)


def _bf16_operands(q, k, v, scale):
    """The same function on bf16 operands alone (q * scale, k, v, p)."""
    def r(t):
        return t.to(torch.bfloat16).float()
    q, k, v = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    p = torch.softmax(r(q * scale) @ r(k).transpose(-1, -2), -1)
    return (r(p) @ r(v)).permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,s,h,d", [
    (2, 300, 1, 512),   # the UNet's D, S not a multiple of any tile
    (1, 257, 3, 64),    # H > 1 over strided views, one key past a 256-key tile
    (1, 1000, 1, 512),  # ragged against the 128-row and 32-key steps
    (2, 33, 2, 192),
])
def test_plain_matches_f64(b, s, h, d):
    _, (q, k, v) = _qkv(b, s, h, d, seed=s)
    scale = 1.0 / math.sqrt(h * d)
    got = sa.split_attention_plain(q, k, v, scale)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32 and got.is_contiguous()
    want, bound = _exact(q, k, v, scale)
    err = (got.double() - want).abs()
    assert bool((err <= 2.0 ** -16 * bound).all())
    bf16_err = (_bf16_operands(q, k, v, scale).double() - want).abs().max().item()
    assert err.max().item() * 16 <= bf16_err


@pytest.mark.parametrize("b,s,h,d", [(2, 300, 1, 512), (1, 130, 2, 128)])
def test_plain_matches_jax_xla_attention(b, s, h, d):
    """The JAX package's attention below its flash gate (two f32 einsums
    and a softmax, on the CPU), within the bound of each from float64."""
    qkv, (q, k, v) = _qkv(b, s, h, d, seed=7)
    scale = 1.0 / math.sqrt(h * d)
    jq, jk, jv = np.split(qkv, 3, axis=-1)
    want = torch.tensor(np.asarray(_xla_attention(jq, jk, jv, scale))).reshape(b, s, h, d)
    got = sa.split_attention_plain(q, k, v, scale)
    _, bound = _exact(q, k, v, scale)
    assert bool(((got.double() - want.double()).abs() <= 2.0 ** -15 * bound).all())


def test_cpu_tensors_take_the_plain_version():
    _, (q, k, v) = _qkv(2, 130, 2, 128, seed=2)
    n0 = sa.LAUNCHES
    got = sa.split_attention(q, k, v, 0.05)
    assert sa.LAUNCHES == n0
    torch.testing.assert_close(got, sa.split_attention_plain(q, k, v, 0.05), rtol=0, atol=0)
    contig = sa.split_attention(q.contiguous(), k.contiguous(), v.contiguous(), 0.05)
    torch.testing.assert_close(got, contig, rtol=0, atol=0)


@pytest.mark.parametrize("shape,kw", [
    ((1, 64, 1, 96), {}),                                  # D % 64 != 0
    ((1, 64, 1, 128), {"dtype": torch.bfloat16}),
    ((1, 64, 1, 128), {"k_shape": (1, 32, 1, 128)}),
    ((1, 64, 1, 128), {"transpose": True}),               # D not unit-stride
])
def test_what_the_kernel_does_not_take_raises(shape, kw):
    q = torch.zeros(shape, dtype=kw.get("dtype", torch.float32))
    k = torch.zeros(kw.get("k_shape", shape), dtype=q.dtype)
    if kw.get("transpose"):
        q = torch.zeros(shape[::-1]).permute(3, 2, 1, 0)
    with pytest.raises(ValueError, match="split_attention"):
        sa.split_attention(q, k, q, 0.1)


def test_other_devices_raise():
    q = torch.empty((1, 64, 1, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sa.split_attention(q, q, q, 0.1)


F32, BF16 = torch.float32, torch.bfloat16
MIN = attention.SPLIT_MIN_TOKENS


HEADS = sa.MAX_HEADS


@pytest.mark.parametrize("dtype,cuda,s,d,grad,bh,route", [
    (F32, True, 4096, 512, False, 9, "split"),      # r3's 64^2 level
    (F32, True, 1024, 512, False, 9, "split"),      # the mid block at 32^2
    (F32, True, MIN, 512, False, 1, "split"),       # at the crossover
    (F32, True, MIN - 1, 512, False, 1, "einsum"),  # below it
    (F32, True, 4096, 512, True, 9, "einsum"),      # the training step records a graph
    (F32, False, 4096, 512, False, 9, "einsum"),    # the CPU
    (BF16, True, 4096, 512, False, 9, "einsum"),    # the bf16 UNet
    (F32, True, 4096, 96, False, 9, "einsum"),      # a D the kernel does not take
    (F32, True, 4096, 192, False, 9, "split"),
    (F32, True, 64, 64, False, HEADS, "split"),     # the most (batch, head) pairs it takes
    (F32, True, 64, 64, False, HEADS + 1, "einsum"),  # one past them
    (F32, True, 16384, 256, False, 9, "flash"),     # x4's 128^2 level
    (F32, True, 16384, 256, True, 9, "flash"),
    (BF16, True, 8192, 128, False, 9, "flash"),
    (F32, True, 8192, 192, False, 9, "split"),      # past the gate, but D % 128 != 0
    (F32, False, 16384, 256, False, 9, "einsum"),
])
def test_route_is_a_function_of_the_call(dtype, cuda, s, d, grad, bh, route):
    assert attention.route(dtype, cuda, s, d, grad, bh) == route


def _routes_after(fn):
    before = dict(attention.LAUNCHES_BY_ROUTE)
    fn()
    return {k: v - before[k] for k, v in attention.LAUNCHES_BY_ROUTE.items()}


def test_every_call_is_counted_by_its_route():
    _, (q, k, v) = _qkv(1, 300, 1, 128, seed=4)
    assert _routes_after(lambda: attention.spatial_attention(q, k, v, 0.1)) == \
        {"flash": 0, "split": 0, "einsum": 1}
    assert _routes_after(lambda: attention.spatial_attention(q, k, v, 0.1, force_flash=True)) == \
        {"flash": 1, "split": 0, "einsum": 0}
    calls = []

    def fake_split(q, k, v, scale):
        calls.append(q.shape)
        return sa.split_attention_plain(q, k, v, scale)

    with mock.patch.object(torch.Tensor, "is_cuda", property(lambda self: True)), \
            mock.patch.object(attention, "split_attention", fake_split):
        out = None

        def run():
            nonlocal out
            out = attention.spatial_attention(q, k, v, 0.1)
        assert _routes_after(run) == {"flash": 0, "split": 1, "einsum": 0}
        assert calls == [q.shape] and out.shape == (1, 300, 128)
        # a call that records a graph keeps the einsum route
        qg = q.clone().requires_grad_(True)
        assert _routes_after(lambda: attention.spatial_attention(qg, k, v, 0.1)) == \
            {"flash": 0, "split": 0, "einsum": 1}
        with torch.no_grad():
            assert _routes_after(lambda: attention.spatial_attention(qg, k, v, 0.1)) == \
                {"flash": 0, "split": 1, "einsum": 0}


def _misaligned(shape):
    """A contiguous (B, S, H, D) tensor whose data starts 4 bytes past a
    16-byte boundary."""
    n = math.prod(shape)
    base = torch.randn(n + 4, generator=torch.Generator().manual_seed(n))
    off = (1 - base.data_ptr() // 4) % 4
    return base[off:off + n].view(shape)


@pytest.mark.parametrize("layout", ["transposed", "misaligned"])
def test_layouts_the_kernel_does_not_read_are_copied(layout):
    """A split-route call whose operands the kernel cannot read in place
    (D not unit-stride, rows not 16-byte aligned) still takes the kernel,
    on a contiguous copy, and gives the einsum route's result."""
    shape = (1, 40, 2, 64)
    if layout == "transposed":
        q = torch.randn(shape[::-1]).permute(3, 2, 1, 0)
    else:
        q = _misaligned(shape)
    k, v = _qkv(*shape, seed=9)[1][1:]
    assert not sa.takes_layout(q) and sa.takes_layout(k) and sa.takes_layout(v)
    read, out = [], {}

    def fake_split(q, k, v, scale):
        read.extend(sa.takes_layout(t) for t in (q, k, v))
        return sa.split_attention_plain(q, k, v, scale)

    def run():
        out["y"] = attention.spatial_attention(q, k, v, 0.1)

    with mock.patch.object(torch.Tensor, "is_cuda", property(lambda self: True)), \
            mock.patch.object(attention, "split_attention", fake_split):
        assert _routes_after(run) == {"flash": 0, "split": 1, "einsum": 0}
    assert read == [True] * 3
    want = attention._einsum_attention(q, k, v, 0.1)
    _, bound = _exact(q, k, v, 0.1)
    assert bool(((out["y"] - want).double().abs().reshape(bound.shape)
                 <= 2.0 ** -15 * bound).all())


# ---------------------------------------------------------- the two metrics


@pytest.mark.parametrize("routes,share", [
    ({"flash": 0, "split": 0, "einsum": 0}, None),
    ({"flash": 0, "split": 24, "einsum": 0}, 100.0),     # an r3 cube
    ({"flash": 100, "split": 20, "einsum": 0}, 100.0),   # an x4 cube
    ({"flash": 100, "split": 0, "einsum": 20}, 100.0 * 100 / 120),
])
def test_kernel_share_reads_the_counter(monkeypatch, routes, share):
    monkeypatch.setattr(attention, "LAUNCHES_BY_ROUTE", dict(routes))
    reader = harness.load_file_module(METRICS / "attention_kernel_share.cube.py")
    assert reader.read(None) == (share if share is None else pytest.approx(share))


def test_kernel_share_is_silent_without_the_counter(monkeypatch):
    """A program whose router has no counter (the parent of the change that
    brought it) reads nothing, and raises nothing."""
    monkeypatch.delattr(attention, "LAUNCHES_BY_ROUTE")
    reader = harness.load_file_module(METRICS / "attention_kernel_share.cube.py")
    assert reader.read(None) is None


def test_core_roofline_counts_operations_once():
    reader = harness.load_file_module(METRICS / "attention_core_roofline.cube.py")
    q = torch.empty(9, 4096, 1, 512, device="meta")
    sig = tuple((n, _describe(q)) for n in ("q", "k", "v")) + (("scale", 1 / math.sqrt(512)),)
    flops, nbytes = reader.work(sig)
    assert flops == 4.0 * 9 * 4096 ** 2 * 512 == pytest.approx(309.2e9, rel=1e-3)
    assert nbytes == 4 * 4.0 * 9 * 4096 * 512
    assert reader.SPANS == {
        "attention_core": "function:hsi_dmgasr_tpu_torch.models.unet:spatial_attention"}


# --------------------------------------------------- against the JAX package
# tests/golden/split_attention_golden.npz: seeded qkv tensors at shapes the
# CUDA kernel takes (D = 512 with S ragged against the 128-row tile; H > 1
# with S one key past a 256-key tile), and the JAX package's _xla_attention
# of their q, k, v on the CPU, for tests/test_torch_cuda.py to hold the
# kernel to where JAX is not installed. Written by
# `PYTHONPATH=. python tests/test_torch_split_attention.py`.

SPLIT_GOLDEN = "split_attention_golden.npz"
GOLDEN_CASES = {"d512": (1, 130, 1, 512), "heads": (1, 257, 2, 64)}


def golden_arrays():
    """{case: qkv, out}: the golden's arrays, out from the JAX package's
    _xla_attention of qkv's q, k, v with scale 1 / sqrt(H D), as (B, S, H, D)."""
    arrays = {}
    for name, (b, s, h, d) in GOLDEN_CASES.items():
        qkv, _ = _qkv(b, s, h, d, seed=11)
        jq, jk, jv = np.split(qkv, 3, axis=-1)
        out = np.asarray(_xla_attention(jq, jk, jv, 1.0 / math.sqrt(h * d)))
        arrays.update({f"{name}.qkv": qkv, f"{name}.out": out.reshape(b, s, h, d)})
    return arrays


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_split_golden_is_the_jax_packages_output(golden_dir, name):
    """The golden's inputs are the seeded ones, and its output is what the
    JAX package gives for them now, to f32 summation order (2^-20 of the
    bound's (1 + 2 A) W)."""
    g = np.load(Path(golden_dir) / SPLIT_GOLDEN)
    fresh = golden_arrays()
    assert sorted(g.files) == sorted(fresh)
    assert np.array_equal(g[f"{name}.qkv"], fresh[f"{name}.qkv"])
    b, s, h, d = GOLDEN_CASES[name]
    q, k, v = torch.tensor(fresh[f"{name}.qkv"]).split(d, dim=-1)
    bound = sa.split_bound(q, k, v, 1.0 / math.sqrt(h * d)).numpy()
    assert (np.abs(g[f"{name}.out"].astype(np.float64) - fresh[f"{name}.out"])
            <= 2.0 ** -20 * bound).all()


if __name__ == "__main__":
    import os

    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(os.path.join(os.path.dirname(__file__), "golden", SPLIT_GOLDEN),
                        **golden_arrays())
