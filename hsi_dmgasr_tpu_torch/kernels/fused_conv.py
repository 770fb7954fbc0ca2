"""Fused GroupNorm -> swish -> 3x3 conv: the UNet Block, on Hopper.

Port of ``hsi_dmgasr_tpu/kernels/fused_conv.py:gn_swish_conv3x3``. The
function is the same; the layout is Hopper's, not the TPU's (no W-pair
packing, no dx packing, no padded Cout):

  out = conv3x3_SAME(swish(GN(x || x2)), bf16(kernel)) + bias
        [+ time_bias[b]] [+ residual]

with optional per-row output moments (``emit_stats``) and the folded 1x1
projection of the raw input (``res_kernel``). Returns
``out[, stats][, res]`` as the JAX function does. The weights are bf16;
the activation is bf16 for bf16 x and kept in f32 for f32 x (the kernel
carries it as two bf16 operands, hi and lo), where the TPU kernel rounds
x, the activation and the residual to bf16 whatever x's dtype: over the
55 Blocks of a full-width f32 UNet those roundings moved the output by
1 % of its largest value.

Host side (plain torch, XLA in JAX): the GroupNorm moments come from
``stats_in`` (per-row [sum, sumsq] chained from the previous Block) or
from one reduction over x, and fold into per-(b, c) scale and shift with
var = E[x^2] - mean^2 clamped at 0, exactly as ``_scale_shift`` does.

Device side: ``csrc/fused_conv.cu`` (CUDA C++ for sm_90a, bound with
ctypes). ``gn_swish_conv3x3`` launches it for CUDA tensors and raises
on what it does not take; for CPU tensors it runs
``gn_swish_conv3x3_plain``, the plain PyTorch version with the kernel's
bf16 roundings. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import build

KC = 32   # channels per K chunk of the CUDA kernel

LAUNCHES = 0


# ----------------------------------------------------------- GroupNorm host side


def _row_moments(x):
    """(B, H, W, C) -> (B, H, 2, C) f32 per-row [sum, sumsq] over W."""
    xf = x.float()
    return torch.stack([xf.sum(2), (xf * xf).sum(2)], 2)


def _reduce_row_stats(st):
    """(B, H, 2, C) per-row partials -> per-channel (sum, sumsq)."""
    tot = st.sum(1)
    return tot[:, 0], tot[:, 1]


def _scale_shift(gn_scale, gn_bias, mean_c, ex2_c, groups, eps):
    """Fold per-channel mean / E[x^2] into per-(b, c) scale and shift."""
    b, c = mean_c.shape
    mean_g = mean_c.reshape(b, groups, c // groups).mean(-1)
    ex2_g = ex2_c.reshape(b, groups, c // groups).mean(-1)
    var = torch.clamp(ex2_g - mean_g ** 2, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mean_bc = mean_g.repeat_interleave(c // groups, dim=1)
    rstd_bc = rstd.repeat_interleave(c // groups, dim=1)
    scale = rstd_bc * gn_scale[None, :].float()
    shift = gn_bias[None, :].float() - mean_bc * scale
    return scale, shift


def gn_scale_shift(x, gn_scale, gn_bias, x2=None, stats_in=None,
                   stats_in2=None, num_groups=32, eps=1e-5):
    """(B, C + C2) f32 scale and shift of GroupNorm over [x, x2]."""
    hw = x.shape[1] * x.shape[2]
    s, s2 = _reduce_row_stats(stats_in if stats_in is not None else _row_moments(x))
    mean_c, ex2_c = s / hw, s2 / hw
    if x2 is not None:
        s, s2 = _reduce_row_stats(
            stats_in2 if stats_in2 is not None else _row_moments(x2))
        mean_c = torch.cat([mean_c, s / hw], 1)
        ex2_c = torch.cat([ex2_c, s2 / hw], 1)
    return _scale_shift(gn_scale, gn_bias, mean_c, ex2_c, num_groups, eps)


# ----------------------------------------------------------------- plain version


def _bf16(t):
    return t.to(torch.bfloat16).float()


def gn_swish_conv3x3_plain(x, gn_scale, gn_bias, kernel, bias, time_bias=None,
                           residual=None, x2=None, stats_in=None, num_groups=32,
                           eps=1e-5, emit_stats=False, res_kernel=None,
                           res_bias=None, stats_in2=None):
    """The kernel's function in plain PyTorch, with its bf16 roundings:
    the weights, and the activation where x is bf16."""
    c = x.shape[-1]
    half = x.dtype == torch.bfloat16
    scale, shift = gn_scale_shift(x, gn_scale, gn_bias, x2, stats_in,
                                  stats_in2, num_groups, eps)

    def act(v, sc, sh):
        a = v.float() * sc[:, None, None, :] + sh[:, None, None, :]
        a = a * torch.sigmoid(a)
        return _bf16(a) if half else a

    a = act(x, scale[:, :c], shift[:, :c])
    if x2 is not None:
        a = torch.cat([a, act(x2, scale[:, c:], shift[:, c:])], -1)
    w = _bf16(kernel).permute(3, 2, 0, 1)
    out = F.conv2d(a.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    out = out + bias.float()
    if time_bias is not None:
        out = out + time_bias.float()[:, None, None, :]
    if residual is not None:
        out = out + residual.float()
    results = [out.to(x.dtype)]
    if emit_stats:
        results.append(torch.stack([out.sum(2), (out * out).sum(2)], 2))
    if res_kernel is not None:
        raw = x.float() if x2 is None else torch.cat([x.float(), x2.float()], -1)
        res = raw @ _bf16(res_kernel).reshape(raw.shape[-1], -1)
        if res_bias is not None:
            res = res + res_bias.float()
        results.append(res.to(x.dtype))
    return results[0] if len(results) == 1 else tuple(results)


# ------------------------------------------------------------------ CUDA kernel


@dataclass(frozen=True)
class PackedConv3x3:
    """Weights in the kernel's layout: bf16 (J, 9, Cout, 32) for the 3x3
    conv (J chunks of 32 input channels) and (J, Cout, 32) for the 1x1 res
    projection."""

    wpack: torch.Tensor
    rpack: torch.Tensor | None
    cin: int
    cout: int


def pack_conv3x3(kernel, res_kernel=None):
    """Pack an HWIO (3, 3, C_total, Cout) kernel (and an optional
    (1, 1, C_total, Cout) res kernel) once, for every later launch."""
    kh, kw, cin, cout = kernel.shape
    if (kh, kw) != (3, 3) or cin % KC:
        raise ValueError(f"kernel {tuple(kernel.shape)}: need 3x3 and C_total % {KC} == 0")
    j = cin // KC
    wpack = (kernel.detach().to(torch.bfloat16).reshape(9, j, KC, cout)
             .permute(1, 0, 3, 2).contiguous())
    rpack = None
    if res_kernel is not None:
        rpack = (res_kernel.detach().to(torch.bfloat16).reshape(j, KC, cout)
                 .permute(0, 2, 1).contiguous())
    return PackedConv3x3(wpack, rpack, cin, cout)


def _entry():
    lib = build.load("fused_conv")
    fn = lib.hsi_gn_swish_conv3x3
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(cond, msg):
    if not cond:
        raise ValueError(f"gn_swish_conv3x3: {msg}")


def _launch(x, gn_scale, gn_bias, kernel, bias, time_bias, residual, x2,
            stats_in, num_groups, eps, emit_stats, res_kernel, res_bias,
            stats_in2, packed):
    global LAUNCHES
    B, H, W, C = x.shape
    C2 = x2.shape[-1] if x2 is not None else 0
    ct = C + C2
    dev = x.device
    _check(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype}")
    _check(x.is_contiguous() and x.data_ptr() % 16 == 0, "x must be contiguous NHWC")
    _check(C % KC == 0 and C2 % KC == 0, f"channels {C}+{C2} must be multiples of {KC}")
    _check(ct % num_groups == 0, f"C_total {ct} % groups {num_groups}")
    if x2 is not None:
        _check(x2.device == dev and x2.dtype == x.dtype and x2.shape[:3] == x.shape[:3],
               "x2 must match x in device, dtype, B, H, W")
        _check(x2.is_contiguous() and x2.data_ptr() % 16 == 0, "x2 must be contiguous NHWC")
    if packed is None:
        packed = pack_conv3x3(kernel, res_kernel)
    cout = packed.cout
    _check(packed.cin == ct and tuple(kernel.shape) == (3, 3, ct, cout),
           f"kernel {tuple(kernel.shape)} vs packed ({ct}, {cout})")
    _check((res_kernel is None) == (packed.rpack is None), "res_kernel vs packed")
    _check(packed.wpack.device == dev, "packed weights on another device")
    if residual is not None:
        _check(residual.shape == (B, H, W, cout) and residual.dtype == x.dtype
               and residual.device == dev and residual.is_contiguous(),
               "residual must be contiguous (B, H, W, Cout) in x.dtype")
    for name, st, c in (("stats_in", stats_in, C), ("stats_in2", stats_in2, C2)):
        if st is not None:
            _check(st.shape == (B, H, 2, c), f"{name} shape {tuple(st.shape)}")
    for name, t, shape in (("gn_scale", gn_scale, (ct,)), ("gn_bias", gn_bias, (ct,)),
                           ("bias", bias, (cout,)), ("time_bias", time_bias, (B, cout)),
                           ("res_bias", res_bias, (cout,))):
        if t is not None:
            _check(t.shape == shape and t.device == dev,
                   f"{name} {tuple(t.shape)} on {t.device}: need {shape} on {dev}")

    scale, shift = gn_scale_shift(x, gn_scale, gn_bias, x2, stats_in,
                                  stats_in2, num_groups, eps)
    scale, shift = scale.contiguous(), shift.contiguous()
    bias = bias.float().contiguous()
    tb = time_bias.float().contiguous() if time_bias is not None else None
    rb = res_bias.float().contiguous() if res_bias is not None else None
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=dev)
    stats = torch.zeros((B, H, 2, cout), dtype=torch.float32, device=dev) if emit_stats else None
    res = torch.empty((B, H, W, cout), dtype=x.dtype, device=dev) if res_kernel is not None else None

    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_ptr(x), _ptr(x2), _ptr(scale), _ptr(shift), _ptr(packed.wpack),
                _ptr(packed.rpack), _ptr(bias), _ptr(tb), _ptr(residual), _ptr(rb),
                _ptr(out), _ptr(stats), _ptr(res), B, H, W, C, C2, cout,
                int(x.dtype == torch.bfloat16), stream)
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"gn_swish_conv3x3 kernel launch failed: cudaError {rc}")
    results = [out]
    if emit_stats:
        results.append(stats)
    if res is not None:
        results.append(res)
    return results[0] if len(results) == 1 else tuple(results)


def gn_swish_conv3x3(x, gn_scale, gn_bias, kernel, bias, time_bias=None,
                     residual=None, x2=None, stats_in=None, num_groups=32,
                     eps=1e-5, emit_stats=False, res_kernel=None,
                     res_bias=None, stats_in2=None, packed=None):
    """Fused GroupNorm(num_groups) -> swish -> conv3x3(SAME) [+ extras].

    x: (B, H, W, C) NHWC; x2: optional (B, H, W, C2) second source read
    as the channel concat [x, x2]; gn_scale, gn_bias: (C + C2,); kernel:
    (3, 3, C + C2, Cout) HWIO; bias: (Cout,); time_bias: (B, Cout);
    residual: (B, H, W, Cout); stats_in / stats_in2: (B, H, 2, C|C2)
    per-row [sum, sumsq] of x / x2; res_kernel: (1, 1, C + C2, Cout) with
    res_bias (Cout,). ``packed``: the weights from ``pack_conv3x3`` of
    the same kernel and res_kernel (callers that launch repeatedly pass
    it so nothing is packed per call).

    Returns (B, H, W, Cout) in x.dtype; with ``emit_stats`` also the
    (B, H, 2, Cout) f32 per-row [sum, sumsq] of the output; with
    ``res_kernel`` also the res projection, last.
    """
    args = (x, gn_scale, gn_bias, kernel, bias, time_bias, residual, x2,
            stats_in, num_groups, eps, emit_stats, res_kernel, res_bias, stats_in2)
    if x.device.type == "cpu":
        return gn_swish_conv3x3_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"gn_swish_conv3x3: unsupported device {x.device}")
    return _launch(*args, packed)
