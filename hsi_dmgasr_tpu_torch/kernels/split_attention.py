"""Attention at f32 class on bf16 tensor cores: softmax(q k^T * scale) v
with every f32 operand carried as a bf16 pair, on Hopper.

``kernels/attention.py:spatial_attention`` routes here the CUDA f32 calls
that record no autograd graph and stay below the flash gate (its
``route``). The kernel keeps the f32 einsum route's function to about
1e-6 of its outputs: no rounding the configurations do not state. Each
f32 operand x is split into hi = bf16(x) and lo = bf16(x - hi), and each
product a.b is taken as a_hi b_hi + a_lo b_hi + a_hi b_lo with f32 sums:

  * q~ = q * scale, an f32 product, then split; k and v split;
  * logits t = log2(e) * q~ k^T in f32, its softmax in f32 in base 2
    (m = max t, p = 2^(t - m), l = sum p);
  * p split, o = p v in f32, out = o / l.

The dropped lo.lo products and the residues past hi + lo are each below
2^-17 of |a| |b|. ``split_attention_plain`` is the same arithmetic in
plain PyTorch.

Device side: ``csrc/split_attention.cu`` (CUDA C++ for sm_90a, bound with
ctypes): a split prepass into bf16 planes, a logits GEMM that also writes
each row's per-tile max and sum, and a p.v GEMM, both on ``wgmma`` fed by
TMA. ``split_attention`` launches it for CUDA tensors and raises on what
it does not take; for CPU tensors it runs the plain version.
``LAUNCHES`` counts calls of the C entry.

Shapes: q, k, v are (B, S, H, D) f32, possibly strided views (the UNet's
qkv split) with unit stride along D; returns a contiguous (B, S, H, D).
"""

from __future__ import annotations

import ctypes
import math
from functools import partial

import torch

from . import build
from .build import split_bf16

LAUNCHES = 0

HEAD_DIM_STEP = 64   # the kernel takes D % 64 == 0 (64-column TMA boxes)
MAX_HEADS = 65535    # B * H: one grid dimension a (batch, head)
TILE_KEYS = 256      # the logits kernel's keys a tile (L_BN): one (max, sum) per row and tile
_LOG2E = 1.0 / math.log(2.0)


def _products(a, b):
    """a_hi b_hi + a_lo b_hi + a_hi b_lo of two split operands, f32 sums."""
    (ah, al), (bh, bl) = a, b
    return ah @ bh + al @ bh + ah @ bl


def split_attention_plain(q, k, v, scale):
    """The kernel's function in plain PyTorch, with its splits and its
    base-2 softmax."""
    q, k, v = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    qs = split_bf16(q * scale)
    ks = tuple(t.transpose(-1, -2) for t in split_bf16(k))
    t = _products(qs, ks) * _LOG2E
    p = torch.exp2(t - t.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = _products(split_bf16(p), split_bf16(v)) / l
    return o.permute(0, 2, 1, 3).contiguous()


# ------------------------------------------------------------------ CUDA kernel


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])


def split_bound(q, k, v, scale):
    """(1 + 2 A_i) W_id in (B, S, H, D), float64: A_i = max_j sum_d |q_id|
    |k_jd| * scale, W_id = sum_j p_ij |v_jd|. A logit moves by at most about
    3 x 2^-18 A_i (the dropped lo.lo product and the residues past hi + lo),
    an output by the logits' moves times sum_j p_ij |v_jd - o_id| <= 2 W_id,
    plus 3 x 2^-18 W_id for p.v: so 2^-16 of this bound holds the kernel and
    its plain version to softmax(q k^T * scale) v, with room for f32 sums."""
    qd, kd, vd = (t.double().permute(0, 2, 1, 3) for t in (q, k, v))
    p = torch.softmax((qd * scale) @ kd.transpose(-1, -2), -1)
    a = ((qd * scale).abs() @ kd.abs().transpose(-1, -2)).amax(-1, keepdim=True)
    return ((1 + 2 * a) * (p @ vd.abs())).permute(0, 2, 1, 3)


def takes_layout(t):
    """Whether the kernel reads t (B, S, H, D) in place: unit stride along
    D, 16-byte-aligned rows (TMA)."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % 4 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1))


_check = partial(build.check, "split_attention")


def _check_inputs(q, k, v):
    """One (B, S, H, D) f32 shape, D % 64 == 0, B * H <= MAX_HEADS, unit
    stride along D, one device: what the kernel takes."""
    _check(q.dim() == 4 and q.shape == k.shape == v.shape
           and q.dtype == k.dtype == v.dtype == torch.float32
           and q.shape[-1] % HEAD_DIM_STEP == 0 and q.shape[1] > 0
           and 0 < q.shape[0] * q.shape[2] <= MAX_HEADS
           and all(t.stride(-1) == 1 for t in (q, k, v)),
           f"q, k, v {tuple(q.shape)} {q.dtype}, {tuple(k.shape)} {k.dtype}, {tuple(v.shape)} "
           f"{v.dtype}: need one (B, S, H, D) f32 shape, D % {HEAD_DIM_STEP} == 0, "
           f"B * H <= {MAX_HEADS}, unit stride along D")
    _check(q.device == k.device == v.device, "q, k, v on different devices")


def buffers(q):
    """The output and the scratch one call on q's shape needs: the six
    bf16 planes, the f32 logits (rows padded to a multiple of 4) and the
    per-tile (max, sum) statistics."""
    b, s, h, d = q.shape
    dev = q.device
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=dev)
    planes = torch.empty((6, b * h, s, d), dtype=torch.bfloat16, device=dev)
    logits = torch.empty((b * h, s, -(-s // 4) * 4), dtype=torch.float32, device=dev)
    stats = torch.empty((b * h, s, -(-s // TILE_KEYS), 2), dtype=torch.float32, device=dev)
    return out, planes, logits, stats


def run_phases(q, k, v, scale, out, planes, logits, stats, phases=7):
    """Run the C entry into the buffers from ``buffers``: ``phases`` 1 runs
    the split, 2 the logits, 4 p.v (each on what an earlier call of the
    others wrote), 7 all three. Counts nothing: ``split_attention`` is the
    wrapper."""
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(takes_layout(t), f"{name} rows must be 16-byte aligned")
    fn = build.entry("split_attention", "hsi_split_attention", _ARGTYPES)
    build.launch("split_attention", fn, q.device, q, k, v, out,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 b, s, h, d, float(scale), planes, logits, stats, phases)
    return out


def split_attention(q, k, v, scale):
    """softmax(q k^T * scale) v per (batch, head) at f32 class:
    (B, S, H, D) f32 -> (B, S, H, D) f32. Launches the kernel for CUDA
    tensors and runs ``split_attention_plain`` for CPU tensors."""
    _check_inputs(q, k, v)
    return build.dispatch("split_attention", q.device,
                          lambda: split_attention_plain(q, k, v, scale),
                          lambda: _launch(q, k, v, scale))


def _launch(q, k, v, scale):
    global LAUNCHES
    out = run_phases(q, k, v, scale, *buffers(q))
    LAUNCHES += 1
    return out
