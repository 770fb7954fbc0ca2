"""Flash attention: softmax(q k^T * scale) v over K/V tiles, on Hopper.

Port of ``hsi_dmgasr_tpu/kernels/flash_attention.py:flash_attention``.
The function is the JAX kernel's: the (S, S) logits are never written,
a running max and sum in f32 rescale the output at every K/V tile, and
keys past S are masked with -1e30. The inputs are all f32 or all bf16;
the operands are rounded as the kernel on the card rounds them:
bf16(q * scale), bf16(k), bf16(v) and bf16(p) into f32 sums; the output
is o / l, rounded once to the inputs' type. With bf16 inputs the scale is
rounded to bf16 first, as the JAX kernel's bf16 ``q_ref[:] * scale``
rounds a Python float (``_operand_scale``).

Device side: ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a, bound with
ctypes). ``flash_attention`` launches it for CUDA tensors and raises on
what it does not take; for CPU tensors it runs ``flash_attention_plain``,
the same function in plain PyTorch, blocked over ``BLOCK_K`` keys as the
JAX kernel is. ``LAUNCHES`` counts calls of the kernel's C entry, which
at D = 128 and 256 runs a bf16 prepass into a scratch buffer that the
wrapper allocates (3 x B*H*S*D bf16) before the attention kernel.

Shapes: q, k, v are (B, S, H, D), possibly strided views (the UNet's
qkv split); returns a contiguous (B, S, H, D) in q.dtype.
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from . import build

LAUNCHES = 0

BLOCK_K = 512        # keys per block of the plain version (the JAX kernel's)
_NEG_INF = -1e30
HEAD_DIMS = (128, 256, 384, 512)   # what the kernel takes: D % 128 == 0, up to 512
BF16_HEAD_DIMS = (128, 256)        # the head dims whose kernel reads a bf16 scratch
DTYPES = (torch.float32, torch.bfloat16)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _operand_scale(scale, dtype):
    """The scale q is multiplied by: rounded to bf16 for bf16 inputs."""
    if dtype == torch.bfloat16:
        return torch.tensor(scale, dtype=torch.bfloat16).item()
    return float(scale)


def flash_attention_plain(q, k, v, scale):
    """The kernel's function in plain PyTorch, with its bf16 roundings."""
    b, s, h, d = q.shape
    scale = _operand_scale(scale, q.dtype)
    qf = _bf16(q.float() * scale).permute(0, 2, 1, 3)
    kf = _bf16(k).permute(0, 2, 1, 3)
    vf = _bf16(v).permute(0, 2, 1, 3)
    o = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    for j in range(0, s, BLOCK_K):
        logits = qf @ kf[:, :, j:j + BLOCK_K].transpose(-1, -2)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        p = torch.exp(logits - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _bf16(p) @ vf[:, :, j:j + BLOCK_K]
        m = m_new
    return (o / l).to(q.dtype).permute(0, 2, 1, 3).contiguous()


# ------------------------------------------------------------------ CUDA kernel


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 2)


_check = partial(build.check, "flash_attention")


def _check_inputs(q, k, v):
    _check(q.dim() == 4 and q.shape == k.shape == v.shape,
           f"q, k, v must share one (B, S, H, D) shape: {tuple(q.shape)}, "
           f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    _check(d in HEAD_DIMS, f"head dim {d}: the kernel takes D % 128 == 0 up to 512")
    _check(s > 0 and 0 < b * h <= 65535, f"S {s}, B*H {b * h}")
    _check(q.dtype == k.dtype == v.dtype and q.dtype in DTYPES,
           f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need all float32 or all bfloat16")
    _check(q.device == k.device == v.device, "q, k, v on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.stride(-1) == 1, f"{name} must have unit stride along D")


def buffers(q):
    """The output and, at the bf16 head dims, the prepass scratch that one
    call on q's shape needs (the scratch None elsewhere)."""
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    scratch = (torch.empty((3, b * h, s, d), dtype=torch.bfloat16, device=q.device)
               if d in BF16_HEAD_DIMS else None)
    return out, scratch


def run_phases(q, k, v, scale, out, scratch, phases=3):
    """Run the C entry into ``out`` and ``scratch`` (from ``buffers``):
    ``phases`` 1 runs the bf16 prepass alone, 2 the attention body alone
    (on the scratch an earlier prepass filled), 3 both. Counts nothing:
    ``flash_attention`` is the wrapper."""
    b, s, h, d = q.shape
    per16 = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.data_ptr() % 16 == 0
               and all(st % per16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1),
               f"{name} rows must be 16-byte aligned")
    fn = build.entry("flash_attention", "hsi_flash_attention", _ARGTYPES)
    build.launch("flash_attention", fn, q.device, q, k, v, out,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 b, s, h, d, _operand_scale(scale, q.dtype), int(q.dtype == torch.bfloat16),
                 phases, scratch)
    return out


def _launch(q, k, v, scale):
    global LAUNCHES
    out = run_phases(q, k, v, scale, *buffers(q))
    LAUNCHES += 1
    return out


def flash_attention(q, k, v, scale):
    """softmax(q k^T * scale) v per (batch, head): (B, S, H, D) -> (B, S, H, D).

    Takes f32 or bf16 with D in {128, 256, 384, 512} and returns q.dtype:
    launches the kernel for CUDA tensors and runs ``flash_attention_plain``
    for CPU tensors."""
    _check_inputs(q, k, v)
    return build.dispatch("flash_attention", q.device,
                          lambda: flash_attention_plain(q, k, v, scale),
                          lambda: _launch(q, k, v, scale))
