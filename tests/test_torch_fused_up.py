"""The up path's four-parity form (``ops/fused_up.py``) and its kernel's
packing and routing (``kernels/up2_conv.py``), on the CPU.

``up2_conv3x3_parity`` is the CUDA kernel's mathematics in plain torch:
each output parity a 2x2 convolution of x, x and the composed taps split
into bf16 hi + lo pairs, summed in f32. Tolerance, elementwise, as a
share of sum |x| |w| over each output's taps: the three products leave
out x_lo W_lo and the residues past hi + lo, each below 2^-18 of |x| |w|
(3 x 2^-18 = 1.1e-5 in all), and f32 sums over K = 4 C taps run in
another order (about 1e-6 here): 2e-5.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hsi_dmgasr_tpu_torch.kernels import up2_conv
from hsi_dmgasr_tpu_torch.ops import fused_up

TOL = 2e-5

# (B, H, W, C, Cout, bias): odd H and W, Cout != C, one pixel
SHAPES = [(2, 5, 7, 32, 64, True), (1, 4, 4, 64, 32, False), (2, 3, 6, 32, 36, True),
          (1, 1, 1, 32, 32, True), (3, 8, 5, 64, 64, False)]


def _case(b, h, w, c, cout, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(b, h, w, c), dtype=torch.float32)
    kernel = torch.tensor(rng.randn(3, 3, c, cout) / np.sqrt(9 * c), dtype=torch.float32)
    bias = torch.tensor(rng.randn(cout), dtype=torch.float32) if with_bias else None
    return x, kernel, bias


def _resize_conv_f64(x, kernel, bias):
    up = F.interpolate(x.double().permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    out = F.conv2d(up, kernel.double().permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    return out if bias is None else out + bias.double()


def _sum_abs(x, kernel):
    """sum |x| |w| over each output's taps, in f64."""
    return _resize_conv_f64(x.abs(), kernel.abs(), None)


@pytest.mark.parametrize("shape", SHAPES)
def test_parity_form_matches_transpose_and_resize_conv(shape):
    x, kernel, bias = _case(*shape)
    got = fused_up.up2_conv3x3_parity(x, kernel, bias)
    scale = _sum_abs(x, kernel)
    exact = _resize_conv_f64(x, kernel, bias)
    today = fused_up.up2_conv3x3(x, kernel, bias)  # the CPU's transposed conv
    assert got.shape == today.shape == exact.shape and got.dtype == torch.float32
    assert ((got.double() - exact).abs() <= TOL * scale).all()
    assert ((got.double() - today.double()).abs() <= TOL * scale).all()


@pytest.mark.parametrize("a,c,dy,dx", [(a, c, dy, dx) for a in (0, 1) for c in (0, 1)
                                       for dy in (0, 1) for dx in (0, 1)])
def test_parity_taps_are_the_composed_taps(a, c, dy, dx):
    _, kernel, _ = _case(1, 1, 1, 32, 8, False)
    taps = fused_up.parity_taps(kernel)
    assert torch.equal(taps[a, c, dy, dx], fused_up._compose_up2(kernel)[a + 2 * dy, c + 2 * dx])


def test_pack_holds_each_tap_as_hi_and_lo():
    _, kernel, _ = _case(1, 1, 1, 64, 40, False)
    taps = fused_up.parity_taps(kernel)
    packed = up2_conv.pack_up2(taps)
    assert packed.wpack.dtype == torch.bfloat16 and (packed.cin, packed.cout) == (64, 40)
    assert packed.wpack.shape == (4, 2, 4, 2, 40, up2_conv.KC)
    hi, lo = fused_up.split_bf16(taps)
    for i, want in enumerate((hi, lo)):
        got = packed.wpack[:, :, :, i].float().permute(0, 2, 1, 4, 3).reshape(2, 2, 2, 2, 64, 40)
        assert torch.equal(got, want)
    # hi + lo holds each f32 tap to 16 bits of mantissa
    assert ((hi + lo - taps).abs() <= 2.0 ** -16 * taps.abs()).all()


def test_cpu_and_bf16_calls_take_the_transpose_route():
    x, kernel, bias = _case(1, 4, 4, 32, 32, True)
    before = dict(up2_conv.LAUNCHES_BY_ROUTE)
    fused_up.up2_conv3x3(x, kernel, bias)
    half = fused_up.up2_conv3x3(x.bfloat16(), kernel.bfloat16(), bias.bfloat16())
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, fused_up.up2_conv3x3_transpose(x.bfloat16(), kernel.bfloat16(),
                                                            bias.bfloat16()))
    assert up2_conv.LAUNCHES_BY_ROUTE == {"kernel": before["kernel"],
                                          "transpose": before["transpose"] + 2}
    assert not up2_conv.takes(x, kernel)


def test_the_spatial_path_keeps_the_transpose_route():
    from hsi_dmgasr_tpu_torch.parallel import spatial

    assert spatial.up2_conv3x3_transpose is fused_up.up2_conv3x3_transpose


@pytest.mark.parametrize("c,cout", [(48, 32), (64, 30)])
def test_the_wrapper_refuses_channels_its_tiles_do_not_take(c, cout):
    x, kernel, _ = _case(1, 4, 4, c, cout, False)
    with pytest.raises(ValueError, match="channels|C %"):
        packed = up2_conv.pack_up2(fused_up.parity_taps(kernel))
        up2_conv.up2_conv3x3(x, packed)


def test_the_wrapper_refuses_a_cpu_tensor():
    x, kernel, _ = _case(1, 4, 4, 32, 32, False)
    with pytest.raises(ValueError, match="CUDA"):
        up2_conv.up2_conv3x3(x, up2_conv.pack_up2(fused_up.parity_taps(kernel)))


def test_weights_are_packed_once_per_version():
    from hsi_dmgasr_tpu_torch.models.unet import Upsample

    up = Upsample(32)
    first = up._pack(up.conv.weight.permute(2, 3, 1, 0))
    assert up._pack(up.conv.weight.permute(2, 3, 1, 0)) is first
    with torch.no_grad():
        up.conv.weight.add_(1.0)
    second = up._pack(up.conv.weight.permute(2, 3, 1, 0))
    assert second is not first
    hi, _ = fused_up.split_bf16(fused_up.parity_taps(up.conv.weight.detach().permute(2, 3, 1, 0)))
    assert torch.equal(second.wpack[:, :, :, 0].float().permute(0, 2, 1, 4, 3)
                       .reshape(2, 2, 2, 2, 32, 32), hi)


def test_upsample_packs_nothing_for_the_transpose_route():
    from hsi_dmgasr_tpu_torch.models.unet import Upsample

    up = Upsample(32).eval()
    x, _, _ = _case(2, 3, 5, 32, 32, False, seed=4)
    with torch.no_grad():
        got = up(x, fused=True)
        want = fused_up.up2_conv3x3_transpose(x, up.conv.weight.permute(2, 3, 1, 0), up.conv.bias)
    assert up._packed is None and torch.equal(got, want)


# --------------------------------------------------- against the JAX package
# tests/golden/up2_conv3x3_golden.npz: seeded x, kernel and bias at shapes the
# CUDA kernel takes (odd H and W, Cout != C, with and without a bias), and the
# JAX package's up2_conv3x3 of them on the CPU, for tests/test_torch_cuda.py to
# hold the kernel to where JAX is not installed. Written by
# `PYTHONPATH=. python tests/test_torch_fused_up.py`.

UP2_GOLDEN = "up2_conv3x3_golden.npz"
GOLDEN_CASES = {"odd": (2, 5, 7, 64, 96, True), "nobias": (1, 9, 6, 32, 36, False)}


def _jax_up2(x, kernel, bias):
    from hsi_dmgasr_tpu.ops.fused_up import up2_conv3x3 as jup

    return np.asarray(jup(x.numpy(), kernel.numpy(), None if bias is None else bias.numpy()))


def golden_arrays():
    """{case: x, kernel, bias (if any), out}: the golden's arrays, out from
    the JAX package."""
    arrays = {}
    for name, shape in GOLDEN_CASES.items():
        x, kernel, bias = _case(*shape, seed=7)
        arrays.update({f"{name}.x": x.numpy(), f"{name}.kernel": kernel.numpy(),
                       f"{name}.out": _jax_up2(x, kernel, bias)})
        if bias is not None:
            arrays[f"{name}.bias"] = bias.numpy()
    return arrays


@pytest.mark.parametrize("shape", SHAPES)
def test_parity_form_matches_the_jax_package(shape):
    x, kernel, bias = _case(*shape, seed=3)
    got = fused_up.up2_conv3x3_parity(x, kernel, bias)
    want = torch.tensor(_jax_up2(x, kernel, bias))
    assert got.shape == want.shape
    assert ((got.double() - want.double()).abs() <= TOL * _sum_abs(x, kernel)).all()


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_up2_golden_is_the_jax_packages_output(golden_dir, name):
    """The golden's inputs are the seeded ones, and its output is what the
    JAX package gives for them now, to f32 summation order (1e-6 of
    sum |x| |w|)."""
    import os

    g = np.load(os.path.join(golden_dir, UP2_GOLDEN))
    fresh = golden_arrays()
    assert sorted(g.files) == sorted(fresh)
    for key in (k for k in fresh if k.startswith(name + ".")):
        if key.endswith(".out"):
            x, kernel = (torch.from_numpy(g[f"{name}.{k}"]) for k in ("x", "kernel"))
            scale = _sum_abs(x, kernel).numpy()
            assert (np.abs(g[key].astype(np.float64) - fresh[key]) <= 1e-6 * scale).all()
        else:
            assert np.array_equal(g[key], fresh[key])


if __name__ == "__main__":
    import os

    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(os.path.join(os.path.dirname(__file__), "golden", UP2_GOLDEN),
                        **golden_arrays())
