"""The collectives of data-parallel training and of camera sharding, below
both the layers and the train step (counterpart of the pmeans in JAX's
shard_map train step, `veon_tpu/train/step.py` with a ("batch",) or
("batch", "cam") mesh, and of the cam-axis psum and all_gather of
`veon_tpu/lift/lss.py` and `veon_tpu/serve/camshard.py`).

The data-parallel sync is ambient: `data_parallel()` reads the
process-global default group of `torch.distributed`, which
`train/distributed.py` `initialize` opens. While one is open, every
train-mode `nn/layers.py` `BatchNorm` averages its batch statistics over
the ranks (`sync_mean`) and the stage-2 step averages its gradients and
losses (`all_reduce_mean`); JAX names the axis on the model instead.
Without a group none of this runs.

Camera sharding names its group: `cam_groups(batch_shards, cam_shards)`
lays the world out as a batch_shards x cam_shards grid (rank = batch row *
cam_shards + cam index) and gives this rank the `CamGroup` of its batch
row. The one cross-camera op of the model sums the lifted grid over that
group (`cam_sum`) and the loss sees every camera through `cam_gather`.
Their backwards are the transposes JAX's shard_map takes with
check_rep=False: the sum's is a sum of the cotangents over the group, the
gather's the sum of the cotangents over the group cut to this rank's
slice. Every rank of a row holds the same loss, so both hand each rank S
times its own cameras' share of a tower parameter's gradient, while a
parameter of the replicated 3D stage gets the row's total on every rank.
The step's mean over the whole world (`all_reduce_mean`) then gives both
what JAX's pmean over "cam" followed by its pmean over "batch" gives:
mean_s(S * share_s) = the row's total, mean over rows after. BatchNorm's
world mean is JAX's mean over "batch" for the same reason: the 3D stage
sees the same grid on every rank of a row.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import torch
import torch.distributed as dist


def data_parallel() -> bool:
    """Whether a process group is open: BatchNorm syncs and the step
    averages over its ranks."""
    return dist.is_available() and dist.is_initialized()


class _SyncMean(torch.autograd.Function):
    """The mean of x over the ranks; its backward is the same mean of the
    cotangents (the transpose of lax.pmean under shard_map)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y / dist.get_world_size()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g / dist.get_world_size()


def sync_mean(x: torch.Tensor) -> torch.Tensor:
    """Differentiable mean of x over the ranks (lax.pmean)."""
    return _SyncMean.apply(x)


@torch.no_grad()
def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, in one all-reduce of one
    flattened buffer (the tensors share a dtype)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    return [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


@dataclasses.dataclass(frozen=True, eq=False)
class CamGroup:
    """This rank's place in a camera-sharded world: the process group of its
    batch row's cam ranks (`group`, None in single-process tests of code
    that only reads the layout), the row's shard count (`size`), this
    rank's camera block (`index`: cameras index*N/size .. (index+1)*N/size)
    and its batch row (`batch_index` of `batch_shards`)."""

    group: Any
    size: int
    index: int
    batch_index: int = 0
    batch_shards: int = 1


def cam_groups(batch_shards: int, cam_shards: int) -> CamGroup:
    """The (batch_shards x cam_shards) grid of the default group's ranks,
    one `dist.new_group` per batch row (every rank makes every row's group,
    as torch requires), and this rank's `CamGroup`."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if batch_shards * cam_shards != world:
        raise ValueError(f"a {batch_shards} x {cam_shards} grid needs {batch_shards * cam_shards} "
                         f"processes; the group has {world}")
    mine = None
    for b in range(batch_shards):
        g = dist.new_group(list(range(b * cam_shards, (b + 1) * cam_shards)))
        if rank // cam_shards == b:
            mine = g
    return CamGroup(mine, cam_shards, rank % cam_shards, rank // cam_shards, batch_shards)


class _CamSum(torch.autograd.Function):
    """The sum of x over the cam group; the backward sums the cotangents
    over the group too (the transpose of lax.psum under check_rep=False)."""

    @staticmethod
    def forward(ctx, x, cg):
        ctx.cg = cg
        y = x.contiguous().clone()
        dist.all_reduce(y, group=cg.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.cg.group)
        return g, None


def cam_sum(x: torch.Tensor, cg: CamGroup) -> torch.Tensor:
    """Differentiable all-reduce sum of x over the cam group, in x's dtype
    (the group's backend must reduce that dtype: it raises otherwise)."""
    return _CamSum.apply(x, cg)


class _CamGather(torch.autograd.Function):
    """The tiled all_gather of x along `axis` over the cam group, in rank
    order; the backward sums the cotangents over the group and keeps this
    rank's slice (lax.all_gather's transpose, psum_scatter)."""

    @staticmethod
    def forward(ctx, x, axis, cg):
        ctx.axis, ctx.cg, ctx.n = axis, cg, x.shape[axis]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(cg.size)]
        dist.all_gather(parts, x.contiguous(), group=cg.group)
        return torch.cat(parts, axis)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.cg.group)
        return g.narrow(ctx.axis, ctx.cg.index * ctx.n, ctx.n), None, None


def cam_gather(x: torch.Tensor, axis: int, cg: CamGroup) -> torch.Tensor:
    """Differentiable tiled all_gather of x along `axis` over the cam group:
    every rank's block, in cam order, concatenated."""
    return _CamGather.apply(x, axis, cg)
