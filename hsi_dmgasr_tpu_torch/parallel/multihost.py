"""Process groups and cross-rank utilities on torch.distributed.

Port of ``hsi_dmgasr_tpu/parallel/multihost.py`` (which supersedes the
reference's distributed/ package: launch.py's mp.spawn with a TCP
rendezvous, distributed.py's collectives):

  * ``initialize`` joins the process group, from its arguments or, given
    none, from ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` (``env://``); a
    single process with neither is left alone, as the JAX package's is.
    The backend follows one rule, decided once from the devices: NCCL
    when every rank has a card of its own, gloo when ranks share a card
    (NCCL refuses two ranks on one device) or run on the CPU.
  * rank and size helpers, ``synchronize`` (a barrier),
    ``all_gather_objects`` and ``per_host_slice`` mirror the JAX ones.
  * ``launch`` spawns the ranks of one host and returns what each rank's
    function returned (distributed/launch.py's role).
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..device import resolve_device


def pick_backend(device, world_size):
    """'nccl' when every rank of this host has a card of its own, else 'gloo'."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if device.type == "cuda" and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device, rank):
    """The rank's device: CUDA without an index means card rank % count
    (so ranks share cuda:0 on a one-card host)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def initialize(init_method=None, world_size=None, rank=None, backend=None, device=None):
    """Join the process group; returns this rank's device.

    ``device`` defaults to CUDA and raises without it; pass
    ``device="cpu"`` for CPU ranks. Without arguments, ``RANK`` and
    ``WORLD_SIZE`` (with ``MASTER_ADDR``/``MASTER_PORT``) are read; a
    process with neither stays a single process. A group that exists
    already is kept."""
    device = resolve_device(device)
    if dist.is_initialized():
        return rank_device(device, dist.get_rank())
    if init_method is None and world_size is None and rank is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            return rank_device(device, 0)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    device = rank_device(device, rank)
    backend = backend or pick_backend(device, world_size)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return device


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary():
    return get_rank() == 0


def synchronize():
    """Barrier across every rank (distributed/distributed.py:40-61)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather_objects(obj):
    """A picklable value from every rank, in rank order."""
    if get_world_size() == 1:
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def per_host_slice(dataset_len, batch_size):
    """(start, stop) index range this rank draws from: the
    DistributedSampler replacement (distributed/distributed.py:135-143)."""
    n, r = get_world_size(), get_rank()
    per = dataset_len // n
    return r * per, (r + 1) * per if r < n - 1 else dataset_len


def _rank_main(rank, fn, world_size, init_method, args, device, out_dir):
    dev = initialize(init_method, world_size, rank, device=device)
    try:
        result = fn(rank, dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn, world_size, init_method, args=(), device=None):
    """Run ``fn(rank, device, *args)`` in ``world_size`` spawned processes
    joined over ``init_method`` (e.g. a ``file://`` store); returns each
    rank's return value, in rank order. ``fn`` must be importable (a
    module-level function). A rank that raises makes this raise."""
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="ranks-")
    try:
        mp.start_processes(_rank_main, args=(fn, world_size, init_method, args, device,
                                             out_dir),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(world_size)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
