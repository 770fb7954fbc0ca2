"""The 2-D ('data', 'space') rank mesh of spatially sharded inference.

Port of ``hsi_dmgasr_tpu/parallel/mesh.py:dmgasr_mesh``, ``shard_spatial``
and ``local_batch_size``. In the JAX package the mesh is a grid of
devices under one controller; here it is a grid of ranks, one process
each: band groups (the folded batch) ride 'data', the image height rides
'space'. Ranks are laid out row-major as the JAX package's devices are:
rank r sits at (r // n_space, r % n_space). Every rank calls
``new_group`` for every row ('space' groups) and every column ('data'
groups), in the same order.

``gather`` is the one collective the spatial path uses: an all_gather
concatenated along a dimension, in rank order (exact data movement).
Over gloo a CUDA tensor goes through host memory. Each mesh counts the
bytes it received from other ranks, by kind.

The data-parallel helpers (``data_parallel_mesh``, ``with_data_sharding``,
``shard_batch``, ``replicate``) serve data-parallel training and are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..device import resolve_device
from .multihost import get_rank, get_world_size, rank_device


@dataclass
class Mesh:
    """This rank's place in an (n_data, n_space) grid, its device, and its
    row ('space') and column ('data') process groups (None in a single
    process)."""

    n_data: int
    n_space: int
    data_idx: int
    space_idx: int
    device: torch.device
    space_group: object = None
    data_group: object = None
    gathered: dict = field(default_factory=dict)  # kind -> bytes from other ranks

    @property
    def shape(self):
        return {"data": self.n_data, "space": self.n_space}


def dmgasr_mesh(n_data, n_space=1, device=None):
    """The ('data', 'space') mesh over every rank of the process group.
    ``device`` defaults to CUDA (each rank's card, ``rank % count``) and
    raises without it; pass ``device="cpu"`` for CPU ranks. Raises unless
    the world holds exactly n_data * n_space ranks: too few cannot form
    the grid, and a rank outside it would have nothing to run."""
    device = resolve_device(device)
    n, world = n_data * n_space, get_world_size()
    if world != n:
        raise ValueError(f"need {n} ranks for a ({n_data}, {n_space}) mesh, have {world}")
    rank = get_rank()
    data_idx, space_idx = divmod(rank, n_space)
    space_group = data_group = None
    if dist.is_initialized():
        for d in range(n_data):
            g = dist.new_group([d * n_space + s for s in range(n_space)])
            if d == data_idx:
                space_group = g
        for s in range(n_space):
            g = dist.new_group([d * n_space + s for d in range(n_data)])
            if s == space_idx:
                data_group = g
    return Mesh(n_data, n_space, data_idx, space_idx, rank_device(device, rank),
                space_group, data_group)


def gather(t, mesh, axis, dim, kind):
    """All ranks' ``t`` along the mesh ``axis`` ('space' or 'data'),
    concatenated along ``dim`` in rank order. Adds the bytes that came
    from the other ranks to ``mesh.gathered[kind]``."""
    group = mesh.space_group if axis == "space" else mesh.data_group
    n = mesh.n_space if axis == "space" else mesh.n_data
    src = t.contiguous()
    if group is None or n == 1:
        parts = [src]
    else:
        via_host = src.is_cuda and dist.get_backend(group) == "gloo"
        if via_host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        if via_host:
            parts = [p.to(t.device) for p in parts]
    nbytes = (n - 1) * src.numel() * src.element_size()
    mesh.gathered[kind] = mesh.gathered.get(kind, 0) + nbytes
    return torch.cat(parts, dim)


def shard_spatial(mesh, x):
    """This rank's block of a (B, H, W, C) tensor: B over 'data', H over
    'space' (each must divide evenly)."""
    b, h = x.shape[:2]
    if b % mesh.n_data or h % mesh.n_space:
        raise ValueError(f"(B, H) = ({b}, {h}) does not divide over the mesh {mesh.shape}")
    bl, hl = b // mesh.n_data, h // mesh.n_space
    return x[mesh.data_idx * bl:(mesh.data_idx + 1) * bl,
             mesh.space_idx * hl:(mesh.space_idx + 1) * hl].contiguous()


def local_batch_size(global_batch, mesh, axis="data"):
    n = mesh.shape[axis]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by mesh axis "
                         f"'{axis}' size {n}")
    return global_batch // n
