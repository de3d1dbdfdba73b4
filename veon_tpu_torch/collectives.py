"""The collectives of data-parallel training, below both the layers and the
train step (counterpart of the pmeans in JAX's shard_map train step,
`veon_tpu/train/step.py` with a ("batch",) mesh and the model built with
bn_axis_name="batch").

The sync is ambient: `data_parallel()` reads the process-global default
group of `torch.distributed`, which `train/distributed.py` `initialize`
opens. While one is open, every train-mode `nn/layers.py` `BatchNorm`
averages its batch statistics over the ranks (`sync_mean`) and the
stage-2 step averages its gradients and losses (`all_reduce_mean`); JAX
names the axis on the model instead. Without a group none of this runs.
"""

from __future__ import annotations

from typing import List, Sequence

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
