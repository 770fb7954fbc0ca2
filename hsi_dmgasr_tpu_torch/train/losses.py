"""HSI training losses (NHWC, PyTorch): a port of ``hsi_dmgasr_tpu/train/losses.py``.

  * ``h_loss``: GELIN HLoss (GELIN.py:453-469): L1 + la1 SAM + la2 L1 on
    3-D gradients. The stage-1 GAE training loss (AE.py:613-614, la1 0.3,
    la2 0.1).
  * ``hybrid_loss``: SSPSR HybridLoss (SSPSR.py:141-160): L1 + 1e-3
    spatial TV + 1e-3 spectral TV (squared-difference TV).
  * ``spe_loss``: GDRRN myloss_spe (GAE/models_GDRRN.py:204-238):
    MSE / (2n) + lamd SAM-sum.

The channel axis is LAST; the reference's dim=1 reductions are dim=-1.
One behaviour differs from the JAX package: at an all-zero spectrum
``torch.linalg.vector_norm``'s gradient is 0 where ``jnp.linalg.norm``'s
is NaN.
"""

from __future__ import annotations

import math

import torch


def cal_sam(y, gt, eps=1e-6):
    """Mean spectral angle / pi (GELIN.py:427-451)."""
    inner = (y * gt).sum(-1, keepdim=True)
    divisor = (torch.linalg.vector_norm(y, dim=-1, keepdim=True)
               * torch.linalg.vector_norm(gt, dim=-1, keepdim=True))
    divisor = divisor + (divisor == 0) * eps
    cos = (inner / divisor).sum(-1).clamp(-1 + eps, 1 - eps)
    return torch.arccos(cos).mean() / math.pi


def cal_gradient(x, eps=1e-6):
    """3-D gradient magnitude on the (1:, 1:, 1:) corner (GELIN.py:405-425):
    the reference trims one voxel off every axis before differencing, so
    the three differences share a shape. x: (B, H, W, C)."""
    core = x[:, 1:, 1:, 1:]
    gc = core - x[:, 1:, 1:, :-1]
    gx = core - x[:, :-1, 1:, 1:]
    gy = core - x[:, 1:, :-1, 1:]
    return torch.sqrt(gx ** 2 + gy ** 2 + gc ** 2 + eps)


def h_loss(y, gt, la1=0.3, la2=0.1, sam=True, gra=True):
    """GELIN HLoss (GELIN.py:453-469)."""
    loss = (y - gt).abs().mean()
    if sam:
        loss = loss + la1 * cal_sam(y, gt)
    if gra:
        loss = loss + la2 * (cal_gradient(y) - cal_gradient(gt)).abs().mean()
    return loss


def _tv_spatial(x, weight=1e-3):
    """Squared-difference spatial TV (SSPSR.py:165-183); x NHWC."""
    b = x.shape[0]
    count_h = x[:, 1:].numel() // b
    count_w = x[:, :, 1:].numel() // b
    h_tv = ((x[:, 1:] - x[:, :-1]) ** 2).sum()
    w_tv = ((x[:, :, 1:] - x[:, :, :-1]) ** 2).sum()
    return weight * (h_tv / count_h + w_tv / count_w) / b


def _tv_spectral(x, weight=1e-3):
    """Squared-difference spectral TV (GELIN.py:389-402); x NHWC."""
    b = x.shape[0]
    count_c = x[..., 1:].numel() // b
    c_tv = ((x[..., 1:] - x[..., :-1]) ** 2).sum()
    return weight * 2 * (c_tv / count_c) / b


def hybrid_loss(y, gt, spatial_tv=True, spectral_tv=True):
    """SSPSR HybridLoss (SSPSR.py:141-160)."""
    loss = (y - gt).abs().mean()
    if spatial_tv:
        loss = loss + _tv_spatial(y)
    if spectral_tv:
        loss = loss + _tv_spectral(y)
    return loss


def spe_loss(y, gt, n, lamd=1e-1, mse_lamd=1.0, eps=1e-12):
    """GDRRN myloss_spe (GAE/models_GDRRN.py:204-238); divides by the
    given ``n``, not by the batch size."""
    mse = ((y - gt) ** 2).sum() / (n * 2)
    h, w = gt.shape[1], gt.shape[2]
    nom = (y * gt).sum(-1)
    den = (torch.linalg.vector_norm(gt, dim=-1).clamp_min(eps)
           * torch.linalg.vector_norm(y, dim=-1).clamp_min(eps))
    sam = torch.nan_to_num(torch.arccos((nom / den).clamp(-1.0, 1.0)))
    return mse_lamd * mse + lamd * sam.sum() / (n * h * w)
