"""Recompute in the backward with a selectable save policy (counterpart of
`veon_tpu/nn/rematutil.py`), over `torch.utils.checkpoint`.

The reference checkpoints whole trunk blocks (`torch.utils.checkpoint` in
`clip_utils/visual.py` / `align_net_occ3d.py`): the backward recomputes
everything in the block. A policy keeps chosen outputs and recomputes the
rest. `remat`, taken by every module whose blocks JAX stacks under
`nn.scan` (one block is one checkpointed region, as one scan body is):

  False / "none" / "false"   no recompute;
  True / "full" / "true"     recompute each block (also "nothing_saveable");
  "<policy>"                 a `jax.checkpoint_policies` name, through
                             `create_selective_checkpoint_contexts`:
    everything_saveable              save every op's output;
    dots_saveable, checkpoint_dots   save every matmul output;
    dots_with_no_batch_dims_saveable,
    checkpoint_dots_with_no_batch_dims
                                     save the matmuls without batch dims.

How the matmuls are counted: `mm` and `addmm` (a Dense on any number of
leading dims folds to them) have no batch dims; `bmm`, `baddbmm` (an
einsum over heads or batch) and the fused attention of
`F.scaled_dot_product_attention` have them. JAX's dots include the
attention einsums, so the fused attention counts as a dot with batch
dims: `dots_saveable` saves its output, the no-batch-dims policies
recompute it. Convolutions are not dots, in JAX or here. JAX's policy
factories (`save_only_these_names` and the like) name tensors by
`checkpoint_name`, which the port does not carry: they raise ValueError.

Train-mode BatchNorm inside a region (`nn/layers.py`) moves its running
stats once per step, as flax's functional remat does: the forward pass
defers the move until the region returns and the recompute makes none.
Its batch statistics (synced over the ranks while a group is open) are
pinned in the recompute to the values the forward pass computed, so the
recomputed activations are the forward's. Random draws repeat
(`preserve_rng_state`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

RematSpec = Union[bool, str]

_DOTS_NO_BATCH = ("mm", "addmm")
_DOTS_BATCH = ("bmm", "baddbmm", "_scaled_dot_product_flash_attention",
               "_scaled_dot_product_efficient_attention", "_scaled_dot_product_cudnn_attention",
               "_scaled_dot_product_flash_attention_for_cpu")
_FACTORIES = ("save_anything_except_these_names", "save_any_names_but_these",
              "save_only_these_names", "save_from_both_policies",
              "save_and_offload_only_these_names", "offload_dot_with_no_batch_dims")
POLICIES = ("nothing_saveable", "everything_saveable", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims")


def parse_policy(tok) -> RematSpec:
    """The CLI's --remat token (JAX `_parse_policy`): full/true -> True,
    none/false -> False, anything else a policy name (checked by
    `remat_wrap`)."""
    if isinstance(tok, bool):
        return tok
    t = tok.strip().lower()
    if t in ("true", "full"):
        return True
    if t in ("false", "none"):
        return False
    return tok.strip()


def _ops(names):
    return {getattr(torch.ops.aten, n).default for n in names if hasattr(torch.ops.aten, n)}


def _save_set(policy: str):
    """The aten ops whose outputs the policy saves; None for every op."""
    if policy == "everything_saveable":
        return None
    if policy in ("dots_saveable", "checkpoint_dots"):
        return _ops(_DOTS_NO_BATCH + _DOTS_BATCH)
    if policy in ("dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims"):
        return _ops(_DOTS_NO_BATCH)
    return set()


def check_policy(remat: RematSpec) -> RematSpec:
    """remat itself when it is a bool or a known policy name; ValueError
    for JAX's policy factories and unknown names."""
    if isinstance(remat, bool) or remat in POLICIES:
        return remat
    if remat in _FACTORIES:
        raise ValueError(f"checkpoint policy {remat!r} is a factory of jax.checkpoint_policies "
                         f"(it names tensors by checkpoint_name, which the port does not carry); "
                         f"refused, as are {', '.join(_FACTORIES)}: use one of "
                         f"{', '.join(POLICIES)}")
    raise ValueError(f"unknown checkpoint policy {remat!r}: use full, none or one of "
                     f"{', '.join(POLICIES)}")


class _Region:
    """One checkpointed call: the batch stats its forward pass computed, in
    call order, and the running-stat moves it deferred."""

    def __init__(self):
        self.stats: List[Tuple[torch.Tensor, ...]] = []
        self.moves: List[Callable[[], None]] = []
        self.recompute = False
        self.next = 0


_local = threading.local()


@contextlib.contextmanager
def _enter(region: _Region, recompute: bool, inner=None):
    prev = getattr(_local, "region", None)
    region.recompute, region.next = recompute, 0
    _local.region = region
    try:
        with inner if inner is not None else contextlib.nullcontext():
            yield
    finally:
        _local.region = prev


def pin_batch_stats(*stats: torch.Tensor):
    """Train-mode BatchNorm's batch statistics: outside a region as they
    are; in a region's forward pass kept, and in its recompute given the
    kept values (the gradient still flows through the recomputed ones).
    Both passes run the same ops, as a selective policy's cache needs."""
    region = getattr(_local, "region", None)
    if region is None:
        return stats
    if region.recompute:
        refs = region.stats[region.next]
        region.next += 1
    else:
        refs = tuple(t.detach() for t in stats)
        region.stats.append(refs)
    return tuple(t + (r - t).detach() for t, r in zip(stats, refs))


def move_running_stats(move: Callable[[], None]) -> None:
    """Run `move` (a BatchNorm running-stat update) now outside a region,
    after the region returns in its forward pass, never in its recompute."""
    region = getattr(_local, "region", None)
    if region is None:
        move()
    elif not region.recompute:
        region.moves.append(move)


def remat_wrap(fn: Callable, remat: RematSpec) -> Callable:
    """fn itself without remat, else fn checkpointed under the policy:
    each call is one region (non-reentrant `torch.utils.checkpoint`)."""
    remat = check_policy(remat)
    if not remat:
        return fn
    selective = isinstance(remat, str) and remat != "nothing_saveable"
    save = _save_set(remat) if selective else set()

    def policy(_ctx, op, *_a, **_k):
        return (CheckpointPolicy.MUST_SAVE if save is None or op in save
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def call(*args, **kwargs):
        region = _Region()

        def contexts():
            fwd, rec = (create_selective_checkpoint_contexts(policy) if selective
                        else (None, None))
            return _enter(region, False, fwd), _enter(region, True, rec)

        out = checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=True,
                         context_fn=contexts, **kwargs)
        for move in region.moves:
            move()
        return out

    return call
