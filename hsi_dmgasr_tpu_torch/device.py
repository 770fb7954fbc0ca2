"""Device selection and the f32 numerics policy for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """The CUDA device unless the caller asks for another one.

    Raises when CUDA is asked for (the default) and there is none: the
    port does not fall back to the CPU by itself.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def use_f32_policy():
    """An f32 run is f32: no TF32 in cuDNN's convolutions or in matmuls.

    The port's f32 inference and training paths call this once before
    they run; torch's own defaults let cuDNN use TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
