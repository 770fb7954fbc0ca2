"""Spatial self-attention over flattened tokens.

Port of ``hsi_dmgasr_tpu/kernels/attention.py``, with its dispatch: long
sequences whose head dim fills 128 lanes go to the flash kernel
(``kernels/flash_attention.py``; on the card a hand-written CUDA kernel),
everything else to softmax(q k^T * scale) v as two matmuls and a softmax,
the counterpart of ``_xla_attention``. In x4 DMGASR under
``configs/pavia_x4.json`` the attention at the 128^2 level of a 512^2
latent (16384 tokens, D = 256) takes the kernel; the mid block (32^2,
1024 tokens) stays on the matmul path.

The JAX package gates on the TPU backend; here the card takes its place:
CUDA tensors that pass the shape gate launch the kernel, CPU tensors take
the matmul path as the JAX package's do off the TPU. ``force_flash``,
like its ``force_pallas``, sends any shape to ``flash_attention``, which
on CPU tensors runs the kernel's plain version.

Shapes: q, k, v are (B, S, H, D); returns (B, S, H*D).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention

# the JAX package's _PALLAS_MIN_TOKENS: sequences at least this long go to
# the flash kernel (when D % 128 == 0)
_FLASH_MIN_TOKENS = 8192


def _einsum_attention(q, k, v, scale):
    b, s, h, d = q.shape
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v)
    return out.reshape(b, s, h * d)


def spatial_attention(q, k, v, scale, force_flash=False):
    b, s, h, d = q.shape
    if force_flash or (s >= _FLASH_MIN_TOKENS and q.is_cuda and d % 128 == 0):
        return flash_attention(q, k, v, scale).reshape(b, s, h * d)
    return _einsum_attention(q, k, v, scale)
