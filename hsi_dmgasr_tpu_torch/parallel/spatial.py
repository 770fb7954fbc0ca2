"""H-axis spatial parallelism: the halo exchange and the sharded convs.

Port of ``hsi_dmgasr_tpu/parallel/spatial.py``. Every rank holds an
H-shard of each (B, H_loc, W, C) activation; the 3x3 convs and the fused
Blocks get their neighbours' boundary rows, and GroupNorm moments come
from gathered per-row partials (``kernels/fused_conv.py:_reduce_row_stats``),
so the sharded forward reproduces the single-device one.

  * ``exchange_halo``: 1-row boundary exchange, both directions, with the
    ring semantics of the JAX package's ``ppermute`` (the rows wrap at
    the true edges; ``edge_mask`` zeroes them there). It is one
    all_gather of every rank's [first row, last row] over 'space', so
    one collective serves NCCL and gloo alike.
  * ``conv3x3_spatial``: stride-1 or stride-2 3x3 conv of an H-shard.
  * ``up2_conv3x3_spatial``: the fused nearest-x2 + conv3x3
    (``ops/fused_up.py``) of an H-shard.
  * ``gather_rows``: the whole image from its H-shards.

Kernels are HWIO, as in the JAX package and ``ops/fused_up.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.fused_up import up2_conv3x3_transpose
from .mesh import gather


def exchange_halo(x, mesh):
    """(prev_row, next_row) of an H-sharded (B, H_loc, W, C) tensor: the
    LAST row of the previous rank's shard and the FIRST row of the next
    rank's, both (B, 1, W, C). At the true image edges they wrap around
    the ring; callers mask them (``edge_mask``)."""
    ends = gather(torch.cat([x[:, :1], x[:, -1:]], 1), mesh, "space", 1, "halo")
    i, n = mesh.space_idx, mesh.n_space
    prev_row = ends[:, 2 * ((i - 1) % n) + 1:2 * ((i - 1) % n) + 2]
    next_row = ends[:, 2 * ((i + 1) % n):2 * ((i + 1) % n) + 1]
    return prev_row.contiguous(), next_row.contiguous()


def edge_flags(mesh):
    """(is_first, is_last): whether this rank holds the image's top or
    bottom rows."""
    return mesh.space_idx == 0, mesh.space_idx == mesh.n_space - 1


def edge_mask(prev_row, next_row, mesh):
    """Zero the halo rows at the true image edges (SAME conv padding)."""
    is_first, is_last = edge_flags(mesh)
    return (torch.zeros_like(prev_row) if is_first else prev_row,
            torch.zeros_like(next_row) if is_last else next_row)


def _extended(x, mesh):
    prev_row, next_row = edge_mask(*exchange_halo(x, mesh), mesh)
    return torch.cat([prev_row, x, next_row], 1)


def conv3x3_spatial(x, kernel, bias, mesh, stride=1):
    """3x3 conv (padding 1) of an H-shard, equal to ``Conv2d(C, Cout, 3,
    stride)`` on the whole image: the halo rows complete each rank's
    receptive field, H is convolved VALID over the extended shard and W
    keeps SAME padding. At stride 2 an even H_loc keeps every rank's
    window phase aligned with the global conv (windows start at global
    rows 2o - 1); an odd one is refused. As ``ops/blocks.py:Conv2d``, the
    kernel is cast to x.dtype and the bias added in the output's dtype."""
    if stride not in (1, 2):
        raise ValueError(f"conv3x3_spatial: stride {stride}, need 1 or 2")
    if stride == 2 and x.shape[1] % 2:
        raise ValueError(f"conv3x3_spatial: stride 2 needs an even H_loc, got {x.shape[1]}")
    xe = _extended(x, mesh).permute(0, 3, 1, 2)
    y = F.conv2d(xe, kernel.to(x.dtype).permute(3, 2, 0, 1), stride=stride, padding=(0, 1))
    if bias is not None:
        y.add_(bias.to(y.dtype)[:, None, None])
    return y.permute(0, 2, 3, 1).contiguous()


def up2_conv3x3_spatial(x, kernel, bias, mesh):
    """nearest-x2 + conv3x3 of an H-shard: ``up2_conv3x3_transpose`` of the shard
    extended by one halo row each side gives 2 * (H_loc + 2) rows, of
    which rows 2 .. 2 * H_loc + 1 are the global op's rows of this shard
    (the two extra rows each side only ever saw the halo)."""
    h = x.shape[1]
    return up2_conv3x3_transpose(_extended(x, mesh), kernel, bias)[:, 2:2 + 2 * h].contiguous()


def gather_rows(x, mesh, kind):
    """The whole (B, H, W, C) tensor from every rank's H-shard."""
    return gather(x, mesh, "space", 1, kind)
