"""Flash attention: softmax(q k^T * scale) v over K/V tiles, on Hopper.

Port of ``hsi_dmgasr_tpu/kernels/flash_attention.py:flash_attention``.
The function is the JAX kernel's: the (S, S) logits are never written,
a running max and sum in f32 rescale the output at every K/V tile, and
keys past S are masked with -1e30. The inputs are f32; the operands are
rounded as the kernel on the card rounds them: bf16(q * scale), bf16(k),
bf16(v) and bf16(p) into f32 sums; the output is o / l in f32.

Device side: ``csrc/flash_attention.cu`` (CUDA C++ for sm_90a, bound with
ctypes). ``flash_attention`` launches it for CUDA tensors and raises on
what it does not take; for CPU tensors it runs ``flash_attention_plain``,
the same function in plain PyTorch, blocked over ``BLOCK_K`` keys as the
JAX kernel is. ``LAUNCHES`` counts calls of the kernel's C entry, which
at D = 128 and 256 runs a bf16 prepass into a scratch buffer that the
wrapper allocates (3 x B*H*S*D bf16) before the attention kernel.

Shapes: q, k, v are (B, S, H, D), possibly strided views (the UNet's
qkv split); returns a contiguous (B, S, H, D).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = 0

BLOCK_K = 512        # keys per block of the plain version (the JAX kernel's)
_NEG_INF = -1e30
HEAD_DIMS = (128, 256, 384, 512)   # what the kernel takes: D % 128 == 0, up to 512
BF16_HEAD_DIMS = (128, 256)        # the head dims whose kernel reads a bf16 scratch


def _bf16(t):
    return t.to(torch.bfloat16).float()


def flash_attention_plain(q, k, v, scale):
    """The kernel's function in plain PyTorch, with its bf16 roundings."""
    b, s, h, d = q.shape
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
    return (o / l).permute(0, 2, 1, 3).contiguous()


# ------------------------------------------------------------------ CUDA kernel


def _entry():
    lib = build.load("flash_attention")
    fn = lib.hsi_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
                       + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _check_inputs(q, k, v):
    _check(q.dim() == 4 and q.shape == k.shape == v.shape,
           f"q, k, v must share one (B, S, H, D) shape: {tuple(q.shape)}, "
           f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    _check(d in HEAD_DIMS, f"head dim {d}: the kernel takes D % 128 == 0 up to 512")
    _check(s > 0 and 0 < b * h <= 65535, f"S {s}, B*H {b * h}")
    _check(q.dtype == k.dtype == v.dtype == torch.float32,
           f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need float32")
    _check(q.device == k.device == v.device, "q, k, v on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.stride(-1) == 1, f"{name} must have unit stride along D")


def _launch(q, k, v, scale):
    global LAUNCHES
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.data_ptr() % 16 == 0
               and all(st % 4 == 0 for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1),
               f"{name} rows must be 16-byte aligned")
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    scratch = (torch.empty((3, b * h, s, d), dtype=torch.bfloat16, device=q.device)
               if d in BF16_HEAD_DIMS else None)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                b, s, h, d, float(scale),
                None if scratch is None else scratch.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def flash_attention(q, k, v, scale):
    """softmax(q k^T * scale) v per (batch, head): (B, S, H, D) -> (B, S, H, D).

    Takes f32 with D in {128, 256, 384, 512}: launches the kernel
    for CUDA tensors and runs ``flash_attention_plain`` for CPU tensors."""
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q, k, v, scale)
