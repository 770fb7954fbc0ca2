"""Spatial self-attention over flattened tokens.

Port of ``hsi_dmgasr_tpu/kernels/attention.py``, with its dispatch: long
sequences whose head dim fills 128 lanes go to the flash kernel
(``kernels/flash_attention.py``; on the card a hand-written CUDA kernel),
everything else to softmax(q k^T * scale) v, the counterpart of
``_xla_attention``. In x4 DMGASR under ``configs/pavia_x4.json`` the
attention at the 128^2 level of a 512^2 latent (16384 tokens, D = 256)
takes the flash kernel; the mid block (32^2, 1024 tokens) does not.

The JAX package gates on the TPU backend; here the card takes its place:
CUDA tensors that pass the shape gate launch the flash kernel, CPU tensors
take the matmul path as the JAX package's do off the TPU. ``force_flash``,
like its ``force_pallas``, sends any shape to ``flash_attention``, which
on CPU tensors runs the kernel's plain version.

Below the flash gate the card has a second kernel, ``split_attention``
(``kernels/split_attention.py``): the same f32 function on bf16 tensor
cores with hi + lo operands, for CUDA f32 calls that record no autograd
graph, at least ``SPLIT_MIN_TOKENS`` long, whose D and B*H it takes.
``route`` decides from what the call shows (dtype, device, S, D, B*H,
grad mode); operands in a layout the kernel does not read are copied. The
rest, the CPU, bf16, the training step's graph-recording calls and
shapes neither kernel takes, stays on ``_einsum_attention``: two matmuls
and a softmax. ``LAUNCHES_BY_ROUTE`` counts every call by its route.

Shapes: q, k, v are (B, S, H, D); returns (B, S, H*D).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .split_attention import HEAD_DIM_STEP, MAX_HEADS, split_attention, takes_layout

# the JAX package's _PALLAS_MIN_TOKENS: sequences at least this long go to
# the flash kernel (when D % 128 == 0)
_FLASH_MIN_TOKENS = 8192
# below the flash gate, the split kernel from this many tokens on: the
# shortest sequence measured, at which it already beat the einsum route on
# an H100 (D = 512, B*H = 1, 2 and 9: its three launches against the
# route's four at sizes where launches set the time; PERF.md)
SPLIT_MIN_TOKENS = 16

LAUNCHES_BY_ROUTE = {"flash": 0, "split": 0, "einsum": 0}


def _einsum_attention(q, k, v, scale):
    b, s, h, d = q.shape
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v)
    return out.reshape(b, s, h * d)


def route(dtype, is_cuda, s, d, records_grad, bh):
    """The route of a call: "flash", "split" or "einsum", from its dtype,
    whether it is on a CUDA device, its sequence length S, head dim D and
    number of (batch, head) pairs B*H, and whether autograd records a graph
    through it."""
    if is_cuda and s >= _FLASH_MIN_TOKENS and d % 128 == 0:
        return "flash"
    if (is_cuda and dtype == torch.float32 and not records_grad and s >= SPLIT_MIN_TOKENS
            and d % HEAD_DIM_STEP == 0 and bh <= MAX_HEADS):
        return "split"
    return "einsum"


def spatial_attention(q, k, v, scale, force_flash=False):
    b, s, h, d = q.shape
    records_grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    which = "flash" if force_flash else route(q.dtype, q.is_cuda, s, d, records_grad, b * h)
    LAUNCHES_BY_ROUTE[which] += 1
    if which == "flash":
        return flash_attention(q, k, v, scale).reshape(b, s, h * d)
    if which == "split":
        # a layout the kernel does not read in place is copied to a fresh
        # contiguous tensor (the UNet's qkv views are read in place)
        q, k, v = (t if takes_layout(t) else t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        return split_attention(q, k, v, scale).reshape(b, s, h * d)
    return _einsum_attention(q, k, v, scale)
