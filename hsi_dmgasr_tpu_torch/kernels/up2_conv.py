"""Nearest-x2 upsample + 3x3 SAME conv + bias, f32 NHWC, on Hopper: the
UNet's up path.

``ops/fused_up.py:up2_conv3x3`` routes a CUDA f32 call whose channels the
kernel takes here (``takes``), with the weights packed once per weight
version (``pack_up2``). Each output parity (a, c) of the (B, 2H, 2W, Cout)
output is a 2x2 convolution of the (B, H, W, C) input with taps composed
from the 3x3 kernel in f32 (``ops/fused_up.py:parity_taps``). The kernel
carries x and the taps as bf16 hi + lo pairs and takes the products
x_hi W_hi + x_lo W_hi + x_hi W_lo on ``wgmma`` with f32 sums: no rounding
the configurations do not state.
Its plain PyTorch version is ``ops/fused_up.py:up2_conv3x3_parity``.

Device side: ``csrc/up2_conv.cu`` (CUDA C++ for sm_90a, bound with
ctypes). ``LAUNCHES_BY_ROUTE`` counts every ``up2_conv3x3`` call by the
route it took: ``"kernel"`` (a launch) or
``"transpose"`` (``F.conv_transpose2d``: the CPU, bf16, and channels the
kernel does not take).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import partial

import torch

from . import build

KC = 32  # channels per K chunk of the CUDA kernel

LAUNCHES_BY_ROUTE = {"kernel": 0, "transpose": 0}


def fits(dtype, cin, cout):
    """Whether the kernel takes a (3, 3, cin, cout) conv in ``dtype``: f32,
    cin % 32 == 0, cout % 4 == 0."""
    return dtype == torch.float32 and cin % KC == 0 and cout % 4 == 0


def takes(x, kernel):
    """Whether the kernel takes this call: x a CUDA (B, H, W, C) tensor,
    kernel a (3, 3, C, Cout) one of x's dtype, that ``fits``."""
    return (x.is_cuda and kernel.dtype == x.dtype and x.dim() == 4 and kernel.dim() == 4
            and tuple(kernel.shape[:3]) == (3, 3, x.shape[-1])
            and fits(x.dtype, x.shape[-1], kernel.shape[-1]))


@dataclass(frozen=True)
class PackedUp2:
    """The four parities' 2x2 taps in the kernel's layout: bf16
    (4 parities, J, 4 taps, 2 (hi, lo), Cout, 32), J chunks of 32 input
    channels."""

    wpack: torch.Tensor
    cin: int
    cout: int


def pack_up2(taps):
    """Pack the (2, 2, 2, 2, C, Cout) f32 parity taps [a, c, dy, dx] once,
    for every later launch: each split into hi = bf16(w), lo = bf16(w - hi)."""
    cin, cout = taps.shape[-2:]
    if tuple(taps.shape[:4]) != (2, 2, 2, 2) or cin % KC:
        raise ValueError(f"taps {tuple(taps.shape)}: need (2, 2, 2, 2, C, Cout), C % {KC} == 0")
    t = taps.detach().float().reshape(4, 4, cin // KC, KC, cout)
    hi = t.to(torch.bfloat16)
    lo = (t - hi.float()).to(torch.bfloat16)
    # (parity, tap, J, KC, Cout) x (hi, lo) -> (parity, J, tap, hi/lo, Cout, KC)
    wpack = torch.stack([hi, lo], 0).permute(1, 3, 2, 0, 5, 4).contiguous()
    return PackedUp2(wpack, cin, cout)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


_check = partial(build.check, "up2_conv3x3 kernel")


def up2_conv3x3(x, packed, bias=None):
    """Launch the kernel: x (B, H, W, C) contiguous f32 on a CUDA device,
    ``packed`` from ``pack_up2`` on the same device, bias (Cout,) or None.
    Returns (B, 2H, 2W, Cout) f32. Raises on what the kernel does not take."""
    _check(x.dim() == 4 and x.dtype == torch.float32,
           f"x {tuple(x.shape)} {x.dtype}: need f32 NHWC")
    B, H, W, C = x.shape
    cout = packed.cout
    _check(C % KC == 0 and cout % 4 == 0,
           f"channels {C} -> {cout}: need C % {KC} == 0 and Cout % 4 == 0")
    _check(packed.cin == C, f"packed for {packed.cin} input channels, x has {C}")
    _check(x.is_cuda, f"needs a CUDA tensor, got {x.device}")
    _check(packed.wpack.device == x.device, "packed weights on another device")
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view's offset: the kernel reads 16-byte units
        x = x.clone()
    if bias is not None:
        _check(bias.shape == (cout,) and bias.device == x.device,
               f"bias {tuple(bias.shape)} on {bias.device}: need ({cout},) on {x.device}")
        bias = bias.float().contiguous()
        if bias.data_ptr() % 16:
            bias = bias.clone()
    out = torch.empty((B, 2 * H, 2 * W, cout), dtype=torch.float32, device=x.device)
    fn = build.entry("up2_conv", "hsi_up2_conv3x3", _ARGTYPES)
    build.launch("up2_conv3x3", fn, x.device, x, packed.wpack, bias, out, B, H, W, C, cout)
    LAUNCHES_BY_ROUTE["kernel"] += 1
    return out
