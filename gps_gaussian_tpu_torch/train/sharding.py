"""Data parallelism over torch.distributed.

Counterpart of gps_gaussian_tpu/train/sharding.py. The JAX package shards
the batch over a ('data',) device mesh and replicates the parameters; here
each process (rank) holds a replica of the model and computes on its rows
of the global batch (`rank_rows`, the counterpart of `shard_batch` :35),
replicated state comes from rank 0 (`broadcast_from_rank0`, of `replicate`
:45), and the training step averages the gradients over the group
(train/trainer.py). A group of None means one process.

`init_distributed` joins the group that `torchrun` describes in the
environment. Unlike the JAX version (:50-64), which warns and carries on in
one process when initialisation fails, it raises: a job of several ranks
that quietly trains alone is the fault this guards against.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def world_size(group: Group = None) -> int:
    """Ranks in `group`; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group = None) -> int:
    """This process's rank in `group`; 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def rank_rows(batch_size: int, group: Group = None) -> slice:
    """This rank's rows of a global batch of `batch_size`: an equal,
    contiguous share, as the ('data',) mesh shards the batch axis."""
    world = world_size(group)
    if batch_size % world:
        raise ValueError(f"batch_size={batch_size} must be divisible by the "
                         f"{world} ranks: each trains on an equal share of "
                         f"the batch")
    per = batch_size // world
    r = rank(group)
    return slice(r * per, (r + 1) * per)


def broadcast_from_rank0(tensors: Iterable[torch.Tensor],
                         group: Group = None) -> None:
    """Overwrite `tensors`, in place on every rank, with rank 0's."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t, src=src, group=group)


def barrier(group: Group = None) -> None:
    if group is not None:
        dist.barrier(group=group)


def init_distributed(device="cuda", backend: Optional[str] = None
                     ) -> Tuple[Group, torch.device]:
    """Join the process group `torchrun` describes (RANK, WORLD_SIZE,
    LOCAL_RANK and MASTER_ADDR/MASTER_PORT in the environment).

    Returns (group, this rank's device). A single process (WORLD_SIZE unset
    or 1) gets (None, `device`) and nothing is initialised. On CUDA each
    rank takes card LOCAL_RANK (torch.cuda.set_device) and the backend is
    nccl; a LOCAL_RANK beyond the visible cards raises, so ranks never
    share a card unasked. On the CPU, or when `backend` says so, it is
    gloo. Any failure to initialise raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = torch.device(device)
    if world <= 1:
        return None, device
    rank_ = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank_))
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        if local_rank >= n_cards:
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} needs card {local_rank}, but "
                f"{n_cards} are visible: start at most one rank per card")
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
        backend = backend or "nccl"
    else:
        backend = backend or "gloo"
    if not dist.is_initialized():
        try:
            dist.init_process_group(backend, init_method="env://",
                                    world_size=world, rank=rank_)
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(
                f"torch.distributed initialisation failed for rank {rank_} "
                f"of {world} ({backend}): {e}") from e
    return dist.group.WORLD, device
