"""Joining the process group, and the sums the port takes over the global
batch (counterpart of the JAX package's `parallel/multihost.py`).

One process drives one device. `initialize()` reads torchrun's environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) and joins
the group: NCCL on a card, gloo on the CPU. Without `WORLD_SIZE`, or at 1,
it joins nothing and the port runs as one process.

The batch is sharded over every rank of the group, so the sums that batch
norm's statistics, the loss normalisers and the evaluation's metrics take
run over the whole group (`world()` ranks). Under GSPMD the JAX package
gets these sums from XLA; here `nn/layers.py::conv_bn`, `train/losses.py`
and `cli.py::_evaluate` call the collectives below. Without a group they
do nothing and the port's single-process code runs, bit for bit. In a
group of one (`initialize(join_alone=True)`) the sums run as collectives
of one rank, which leave every value as it is.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize(device: str = "cuda", init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               join_alone: bool = False) -> Tuple[int, int]:
    """Join the process group named by torchrun's environment (or by the
    arguments) and return (rank, world); (0, 1) and nothing joined when the
    world is 1, unless `join_alone` asks for a group of one. On a card the
    process takes device `LOCAL_RANK` and joins over NCCL, and a failure
    raises: there is no fall back to gloo or to the CPU. `device="cpu"`
    joins over gloo. Joining twice returns the group's (rank, world)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and not join_alone:
        return 0, 1
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build of PyTorch")
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a distributed run on the card needs CUDA")
        if not dist.is_nccl_available():
            raise RuntimeError("NCCL is not available: a distributed run on the card needs it")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method=init_method, rank=rank, world_size=world,
                                device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    return rank, world


def shutdown() -> None:
    """Leave the group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_shard() -> Tuple[int, int]:
    """(rank, world): the loader's shard (`data/loader.py`)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    """True on the rank that prints and writes files (rank 0)."""
    return host_shard()[0] == 0


def global_batch_to_local(global_batch_size: int, world: Optional[int] = None) -> int:
    """One rank's share of a global batch; raises where it does not
    divide."""
    world = host_shard()[1] if world is None else world
    if global_batch_size % world:
        raise ValueError(f"the global batch {global_batch_size} does not divide over "
                         f"{world} ranks")
    return global_batch_size // world


def joined() -> bool:
    """True in a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of ranks the batch is sharded over: the group's size, or
    1 without a group."""
    return dist.get_world_size() if joined() else 1


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the group (a new tensor, no gradient; in a group
    of one too); t itself without a group. No host sync: the collective is
    queued on t's stream."""
    if not joined():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def all_gather_cat(t: torch.Tensor) -> torch.Tensor:
    """Every rank's t (equal shapes), concatenated along dim 0 in rank
    order (in a group of one too); t itself without a group."""
    if not joined():
        return t
    parts = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def any_rank(flag: bool) -> bool:
    """True where `flag` is true on any rank (one small collective; a host
    read)."""
    if world() == 1:
        return flag
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
