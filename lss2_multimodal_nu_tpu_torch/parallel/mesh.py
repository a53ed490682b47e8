"""The (dp, fsdp) device mesh and the two ways a model is spread over it
(counterpart of the JAX package's `parallel/mesh.py`).

As in the JAX package, the batch is sharded over both axes (every rank
holds `--bsize // world` samples of each global batch), the parameters are
replicated over dp and sharded over fsdp. `make_mesh` builds the
`DeviceMesh`; `shard_state` spreads a model over it:

- **fsdp == 1, replicated.** Every rank holds every parameter, rank 0's
  values broadcast at the start; after the backward `reduce_gradients`
  sums the gradients over the group in buckets of `BUCKET_BYTES`. It sums
  where DDP averages: each rank's loss is its share of the global batch's
  loss (`train/losses.py`), so the sum of the ranks' gradients is the
  gradient of the global loss. Parameters that get no gradient (stage 4 of
  the VoVNet trunk at LSS v1, ROADMAP fault 7) have none on every rank and
  are left out, as one process leaves them.
- **fsdp > 1, FSDP2.** `fully_shard` over the fsdp axis (over the whole
  mesh as HSDP where dp > 1), its gradients summed (divide factor 1) for
  the same reason. FSDP2 gathers a group's parameters in the pre-forward hook
  of its module, so a group must be a module whose `forward` runs: the
  port reads many children's weights functionally (`conv_bn(x, conv,
  bn)`, `linear(x, m)`), and a group over such a child would leave its
  parameters sharded when its parent reads them. The groups are therefore
  taken among modules whose forward every family calls: the model's
  top-level children and the OSA stages of a VoVNet trunk, each one that
  holds a parameter of at least `MIN_SHARD_ELEMS` (JAX's 2^19-element
  floor, `param_sharding`), deepest first; the root takes the rest.

  Where this differs from JAX's per-leaf rule: FSDP2 shards every
  parameter of a group, so the leaves under 2^19 elements, which JAX keeps
  replicated, are sharded here too (in the all-gather of their group or of
  the root); the large leaves are sharded by both (`tests/test_torch_dist.py`
  lists the sets). FSDP2 shards dim 0 (padded where it does not divide),
  where JAX takes the largest axis that divides.

`constrain_batch` and `activate_mesh` (GSPMD's sharding hints) have no
counterpart: each rank runs its own shard of the batch as a whole model.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from . import multihost

MIN_SHARD_ELEMS = 2 ** 19
BUCKET_BYTES = 25 * 2 ** 20


def make_mesh(cfg, device_type: str = "cuda"):
    """The (dp, fsdp) `DeviceMesh` of `cfg.mesh` over the group, axes named
    "dp" and "fsdp"; None when no group is joined and dp = fsdp = 1 (one
    process). Exits with a message where dp * fsdp is not the world
    size."""
    dp, fsdp = cfg.mesh.dp, cfg.mesh.fsdp
    world = multihost.host_shard()[1]
    if dp < 1 or fsdp < 1 or dp * fsdp != world:
        raise SystemExit(f"--dp {dp} x --fsdp {fsdp} must equal the number of processes, "
                         f"WORLD_SIZE={world} (run under torchrun --nproc_per_node "
                         f"{max(dp, 1) * max(fsdp, 1)})")
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, fsdp), mesh_dim_names=("dp", "fsdp"))


def fsdp_groups(model: nn.Module) -> List[str]:
    """The names of the modules that `shard_state` makes FSDP groups of,
    deepest first (the module docstring): the model's top-level children
    and the OSA stages of a VoVNet trunk that hold a parameter of at least
    `MIN_SHARD_ELEMS` elements outside the deeper groups."""
    from ..nn.vovnet import OsaStage

    candidates = [(name, m) for name, m in model.named_modules()
                  if name and ("." not in name or isinstance(m, OsaStage))]
    names, taken = [], set()
    for name, m in sorted(candidates, key=lambda c: -c[0].count(".")):
        own = [p for p in m.parameters() if id(p) not in taken]
        if any(p.numel() >= MIN_SHARD_ELEMS for p in own):
            names.append(name)
            taken.update(id(p) for p in own)
    return names


def _broadcast_from_rank0(model: nn.Module) -> None:
    """Every parameter and buffer set to rank 0's values."""
    if multihost.world() == 1:
        return
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, 0)


def shard_state(model: nn.Module, mesh, wrapper: Optional[str] = None) -> nn.Module:
    """`model` spread over `mesh` (the module docstring): "replicate" where
    the fsdp axis is 1, "fsdp" (FSDP2) where it is larger; `wrapper` picks
    one whatever the axis (FSDP2 on a mesh of one rank, say). The model is
    changed in place and returned; a None mesh leaves it as it is."""
    if mesh is None:
        return model
    wrapper = wrapper or ("fsdp" if mesh["fsdp"].size() > 1 else "replicate")
    _broadcast_from_rank0(model)
    if wrapper == "replicate":
        return model
    if wrapper != "fsdp":
        raise ValueError(f"unknown wrapper {wrapper!r}")
    from torch.distributed.fsdp import fully_shard

    sub = mesh if mesh["dp"].size() > 1 else mesh["fsdp"]
    modules = dict(model.named_modules())
    for name in fsdp_groups(model) + [""]:
        group = fully_shard(modules[name], mesh=sub)
        # a plain sum (no PREMUL_SUM, which gloo lacks, and no division)
        group.set_gradient_divide_factor(1.0)
        group.set_force_sum_reduction_for_comms(True)
    return model


def reduce_gradients(model: nn.Module) -> None:
    """Sum the gradients over the group, for a replicated model (FSDP2
    reduces its own in the backward), in a group of one too; nothing
    without a group. Buckets of
    `BUCKET_BYTES`, each one all-reduce of the gradients flattened."""
    from torch.distributed.fsdp import FSDPModule

    if not multihost.joined() or isinstance(model, FSDPModule):
        return
    buckets, size = [[]], 0
    for g in (p.grad for p in model.parameters() if p.grad is not None):
        nbytes = g.numel() * g.element_size()
        if buckets[-1] and (size + nbytes > BUCKET_BYTES or g.dtype != buckets[-1][0].dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    for bucket in buckets:
        if not bucket:
            continue
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        torch._foreach_copy_(bucket, [f.view_as(g) for f, g in
                                      zip(flat.split([g.numel() for g in bucket]), bucket)])
