"""The port's flash attention and its dispatch against the JAX package.

``flash_attention_plain`` is held against the JAX ``flash_attention`` run
in Pallas interpret mode, as tests/test_flash_attention.py runs it. The
JAX kernel on the CPU keeps f32 operands; the port rounds q * scale, k, v
and p to bf16 as its kernel does on the card, with f32 sums. Tolerance:
5e-3 absolute, for that bf16 operand rounding: the cases below differ by
at most 2.3e-3 on their seeds, where outputs are typically 0.04-0.09. A
plain version that counted the zero-filled tail keys of the (300, 1, 64)
case in its softmax sum would move those outputs by about 2e-2.
"""

from unittest import mock

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hsi_dmgasr_tpu.kernels.flash_attention import flash_attention as j_flash
from hsi_dmgasr_tpu_torch.kernels import attention
from hsi_dmgasr_tpu_torch.kernels import flash_attention as fa


def _qkv(b, s, h, d, seed=0):
    """q, k, v as the UNet makes them: strided views of one qkv tensor."""
    rng = np.random.RandomState(seed)
    qkv = rng.randn(b, s, h, 3 * d).astype(np.float32)
    return qkv, [torch.tensor(qkv).split(d, dim=-1)[i] for i in range(3)]


@pytest.mark.parametrize("s,h,d", [
    (300, 1, 64),    # S not a multiple of the tile: masked tail
    (520, 2, 128),   # multi-head, two K blocks
    (200, 1, 256),   # the main path's head dim
])
def test_plain_matches_jax_flash(s, h, d):
    qkv, (q, k, v) = _qkv(2, s, h, d)
    scale = 1.0 / np.sqrt(h * d)
    jq, jk, jv = np.split(qkv, 3, axis=-1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_flash(jq, jk, jv, scale))
    got = fa.flash_attention_plain(q, k, v, scale)
    assert got.shape == (2, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    _, (q, k, v) = _qkv(2, 130, 2, 128, seed=2)
    n0 = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, 0.05)
    assert fa.LAUNCHES == n0
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v, 0.05), rtol=0, atol=0)
    # strided views and contiguous copies give the same result
    contig = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), 0.05)
    torch.testing.assert_close(got, contig, rtol=0, atol=0)


def test_other_devices_raise():
    q = torch.empty((1, 64, 1, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q, 0.1)


@pytest.mark.parametrize("shape,kw,match", [
    ((1, 64, 1, 64), {}, "head dim"),
    ((1, 64, 1, 640), {}, "head dim"),
    ((1, 64, 1, 128), {"dtype": torch.float16}, "dtypes"),
    ((1, 64, 1, 128), {"k_shape": (1, 32, 1, 128)}, "share one"),
    ((1, 64, 1, 128), {"transpose": True}, "unit stride"),
])
def test_shapes_the_kernel_does_not_take_raise(shape, kw, match):
    q = torch.zeros(shape, dtype=kw.get("dtype", torch.float32))
    k = torch.zeros(kw.get("k_shape", shape), dtype=q.dtype)
    if kw.get("transpose"):
        q = torch.zeros(shape[::-1]).permute(3, 2, 1, 0)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, q, 0.1)


@pytest.mark.parametrize("s,d,route", [
    (8192, 128, "flash"),
    (8191, 128, "split"),    # below the flash gate: the f32 split kernel
    (8192, 192, "split"),    # D % 128 != 0: not flash's; D % 64 == 0: the split kernel's
    (8192, 96, "einsum"),    # neither kernel takes D = 96
    (16384, 256, "flash"),   # configs/pavia_x4.json: the 128^2 level of a 512^2 latent
    (1024, 512, "split"),    # its mid block at 32^2
])
def test_gate_sends_what_the_jax_gate_sends(s, d, route):
    """hsi_dmgasr_tpu/kernels/attention.py:40-44 with the card in the
    TPU's place: S >= 8192, a CUDA tensor and D % 128 == 0, or forced.
    The card is stood in for by reporting the CPU tensor as a CUDA one;
    off the card every shape takes the einsum path, as off the TPU. Below
    the JAX package's gate the card's f32 calls that record no graph take
    the split kernel where it takes D."""
    q = torch.zeros((1, s, 1, d))
    calls = []

    def record(name, shape):
        def fn(q, k, v, scale):
            calls.append(name)
            return torch.zeros(shape)
        return fn

    with mock.patch.object(attention, "flash_attention", record("flash", (1, s, 1, d))), \
            mock.patch.object(attention, "split_attention", record("split", (1, s, 1, d))), \
            mock.patch.object(attention, "_einsum_attention", record("einsum", (1, s, d))):
        out = attention.spatial_attention(q, q, q, 0.1)
        assert calls == ["einsum"] and out.shape == (1, s, d)
        attention.spatial_attention(q, q, q, 0.1, force_flash=True)
        assert calls[1:] == ["flash"]
        with mock.patch.object(torch.Tensor, "is_cuda", property(lambda self: True)):
            out = attention.spatial_attention(q, q, q, 0.1)
    assert calls[2:] == [route]
    assert out.shape == (1, s, d)


def test_flash_route_matches_einsum_route():
    """Both routes compute one function: f32 einsum against the bf16
    flash path, 5e-3 absolute for the operand rounding (2.0e-3 on this
    seed, outputs typically 0.08)."""
    _, (q, k, v) = _qkv(2, 256, 1, 128, seed=3)
    flash = attention.spatial_attention(q, k, v, 1.0 / np.sqrt(128), force_flash=True)
    einsum = attention._einsum_attention(q, k, v, 1.0 / np.sqrt(128))
    torch.testing.assert_close(flash, einsum, atol=5e-3, rtol=0)
