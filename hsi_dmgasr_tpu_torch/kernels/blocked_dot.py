"""Blocked dot x @ w, int8 -> int32 or bf16 -> f32, on Hopper.

Port of ``tools/microbench_int8.py:pallas_dot``'s kernel (``kern``, the
``pl.pallas_call`` at :88): each (bm, bn) output block is the full-K dot
of an x row block and a w column block, so the function is the whole
product, summed in int32 for int8 operands (exact) and in f32 for bf16.

Device side: ``csrc/blocked_dot.cu`` (CUDA C++ for sm_90a, ``wgmma`` fed
by a TMA ring, bound with ctypes). It reads w packed K-major,
``pack_dot_weight(w)``, the layout ``wgmma`` takes for 8-bit operands,
done once outside a chain as the JAX package packs conv weights.
``blocked_dot`` launches it for CUDA tensors and raises on what it does
not take; for CPU tensors it runs ``blocked_dot_plain``. ``LAUNCHES``
counts kernel launches.

(bm, bn) are the Pallas blocks. The kernel tiles the output its own way,
but it keeps their contract: the grid (M // bm, N // bn) leaves a ragged
remainder undefined, so M % bm and N % bn must be 0.
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from . import build

LAUNCHES = 0

# operand dtype -> (output dtype, the MMA's k: K must be a multiple of it)
DTYPES = {torch.int8: (torch.int32, 32), torch.bfloat16: (torch.float32, 16)}


def blocked_dot_plain(x, w):
    """x (M, K) @ w (K, N) in plain PyTorch: int8 -> int32, bf16 -> f32.

    On the CPU int8 sums are taken in int32. The card has no integer
    matmul outside a library call, so there both types are summed in
    float64 and cast back: exact for int8 (|sums| < 2^53), one rounding
    to f32 for bf16."""
    if x.dtype == torch.int8 and x.device.type == "cpu":
        return x.to(torch.int32) @ w.to(torch.int32)
    return (x.double() @ w.double()).to(DTYPES[x.dtype][0])


def pack_dot_weight(w):
    """(K, N) -> the kernel's K-major (N, K), contiguous."""
    return w.t().contiguous()


# ------------------------------------------------------------------ CUDA kernel


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


_check = partial(build.check, "blocked_dot")


def _check_inputs(x, w_packed, bm, bn):
    _check(x.dim() == 2 and w_packed.dim() == 2 and x.shape[1] == w_packed.shape[1],
           f"need x (M, K) and packed w (N, K): {tuple(x.shape)}, {tuple(w_packed.shape)}")
    _check(x.dtype == w_packed.dtype and x.dtype in DTYPES,
           f"dtypes {x.dtype}, {w_packed.dtype}: need both int8 or both bfloat16")
    (m, k), n = x.shape, w_packed.shape[0]
    mma_k = DTYPES[x.dtype][1]
    _check(k > 0 and k % mma_k == 0, f"K {k}: must be a multiple of {mma_k} for {x.dtype}")
    _check(bm > 0 and bn > 0 and m % bm == 0 and n % bn == 0,
           f"(M, N) = ({m}, {n}) not tiled by blocks ({bm}, {bn})")
    _check(x.device == w_packed.device, "x and w on different devices")
    _check(x.is_contiguous() and w_packed.is_contiguous(), "x and packed w must be contiguous")


def _launch(x, w_packed):
    global LAUNCHES
    (m, k), n = x.shape, w_packed.shape[0]
    _check(x.data_ptr() % 16 == 0 and w_packed.data_ptr() % 16 == 0,
           "x and packed w must be 16-byte aligned")
    out = torch.empty((m, n), dtype=DTYPES[x.dtype][0], device=x.device)
    fn = build.entry("blocked_dot", "hsi_blocked_dot", _ARGTYPES)
    build.launch("blocked_dot", fn, x.device, x, w_packed, out,
                 m, n, k, int(x.dtype == torch.int8))
    LAUNCHES += 1
    return out


def blocked_dot(x, w_packed, bm, bn):
    """x (M, K) @ w (K, N), with w given as ``pack_dot_weight(w)``.

    int8 -> int32 or bf16 -> f32: launches the kernel for CUDA tensors
    and runs ``blocked_dot_plain`` for CPU tensors."""
    _check_inputs(x, w_packed, bm, bn)
    return build.dispatch("blocked_dot", x.device, lambda: blocked_dot_plain(x, w_packed.t()),
                          lambda: _launch(x, w_packed))
