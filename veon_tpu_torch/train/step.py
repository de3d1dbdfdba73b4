"""The optimizer, the EMA and the stage-2 train step on one device
(counterpart of `veon_tpu/train/step.py` with mesh=None): forward with
train-mode BatchNorm, the occupancy loss, the backward, AdamW with
global-norm clipping and linear warmup over the trainable params only,
optional gradient accumulation, and the EMA of params and BatchNorm
running stats.

Params and running stats live in the model and are updated in place; the
optimizer moments, the EMA copies and the counters live in `TrainState`
beside the model. The optimizer is optax's chain written out by hand, rule
for rule: clip_by_global_norm (t / norm * max_norm when norm >= max_norm;
no epsilon, unlike torch's clip_grad_norm_), adamw (bias-corrected
moments, decay added to the Adam direction) and a schedule read at the
count BEFORE the step's increment; the frozen params (optax's
set_to_zero partition) are not in it at all. accum_steps > 1 is
optax.MultiSteps: each micro-step folds its gradient into a running mean,
acc + (g - acc) / (n + 1), and every accum_steps-th applies one update of
that mean, the inner count (clip, bias correction, warmup) advancing once
per update.

While a process group is open (`collectives.py`, one rank per card), the
step is JAX's shard_map step over a ("batch",) mesh: BatchNorm syncs
its batch stats, and the gradients (before the optimizer, so accumulation
folds their mean) and the losses are averaged over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import collectives
from ..configs.base import VeonConfig
from ..model.veon import VeonModel
from ..nn.layers import BatchNorm
from .losses import occupancy_loss

# CLIP towers, side adapter and depth tower are frozen in stage 2; the
# effective trainable set is hsa / lift_fusion / alignnet.
STAGE2_FROZEN_PREFIXES = ("depth", "side_adapter", "clip_visual", "rec_head")


def stage2_trainable(path: Tuple[str, ...]) -> bool:
    return path[0] not in STAGE2_FROZEN_PREFIXES


def trainable_mask(model: nn.Module, predicate: Callable[[Tuple[str, ...]], bool]
                   ) -> Dict[str, bool]:
    """{param name: predicate(its path)}, the path being the name's
    components (the flax path with the scan index of an unstacked block)."""
    return {n: bool(predicate(tuple(n.split(".")))) for n, _ in model.named_parameters()}


def trainable_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The params `create_train_state` left trainable (requires_grad)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


@dataclasses.dataclass
class AdamState:
    count: int  # optimizer updates applied
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    mini_step: int = 0  # micro-steps folded into acc_grads since the last update
    acc_grads: Optional[Dict[str, torch.Tensor]] = None  # accum_steps > 1: the running mean


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The reference recipe's optimizer: AdamW(lr 1e-4, wd 1e-2) after a
    global-norm clip at 5, with a linear warmup from lr * warmup_ratio over
    warmup_iters steps, one update per `accum_steps` micro-steps. It updates
    the params it is given: `create_train_state` decides which are
    trainable."""

    lr: float = 1e-4
    weight_decay: float = 1e-2
    warmup_iters: int = 200
    warmup_ratio: float = 1e-3
    max_norm: float = 5.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    accum_steps: int = 1

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}  # noqa: E731
        return AdamState(0, zeros(), zeros(), 0, zeros() if self.accum_steps > 1 else None)

    def learning_rate(self, count: int) -> torch.Tensor:
        """optax linear_schedule joined to a constant, in fp32."""
        if count >= self.warmup_iters:
            return torch.tensor(self.lr, dtype=torch.float32)
        init = self.lr * self.warmup_ratio
        frac = 1 - torch.tensor(max(count, 0), dtype=torch.float32) / self.warmup_iters
        return (init - self.lr) * frac + self.lr

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Mapping[str, torch.Tensor]) -> AdamState:
        """One micro-step: with accumulation, fold `grads` into the running
        mean and return unless this is the accum_steps-th; else one step on
        the (mean) gradient, applied to `params` in place. The returned
        state's mini_step is 0 exactly when params moved."""
        names = list(params)
        dev = params[names[0]].device
        if self.accum_steps > 1:
            n = torch.tensor(float(state.mini_step + 1), device=dev)
            acc = {k: state.acc_grads[k] + (grads[k] - state.acc_grads[k]) / n for k in names}
            if state.mini_step < self.accum_steps - 1:
                return dataclasses.replace(state, mini_step=state.mini_step + 1, acc_grads=acc)
            grads = acc
        norm = torch.sqrt(sum(torch.sum(grads[n] * grads[n]) for n in names))
        count = state.count + 1
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
        step_size = -self.learning_rate(state.count).to(dev)
        for n in names:
            g = grads[n]
            # optax's clip: t below the max norm, else (t / norm) * max_norm
            g = torch.where(norm < self.max_norm, g, g / norm * self.max_norm)
            mu = (1 - self.b1) * g + self.b1 * state.mu[n]
            nu = (1 - self.b2) * (g * g) + self.b2 * state.nu[n]
            upd = (mu / bc1.to(dev)) / (torch.sqrt(nu / bc2.to(dev)) + self.eps)
            upd = upd + self.weight_decay * params[n]
            params[n].add_(step_size * upd)
            state.mu[n], state.nu[n] = mu, nu
        acc = None if state.acc_grads is None else {k: torch.zeros_like(v)
                                                    for k, v in state.acc_grads.items()}
        return AdamState(count, state.mu, state.nu, 0, acc)


def ema_decay(updates: torch.Tensor, decay: float = 0.999) -> torch.Tensor:
    """MEGVII EMA ramp: decay * (1 - exp(-x / 2000)), fp32."""
    return decay * (1.0 - torch.exp(-updates / 2000.0))


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Mapping[str, torch.Tensor], d):
    """ema <- ema * d + (1 - d) * new, in place (multi-tensor kernels)."""
    names = list(ema)
    es = [ema[n] for n in names]
    torch._foreach_mul_(es, d)
    torch._foreach_add_(es, torch._foreach_mul([new[n].detach() for n in names], 1.0 - d))


def ema_step_fields(ema_updates: torch.Tensor, opt_state: AdamState):
    """(effective decay, new update count) of one micro-step, gated on the
    optimizer having applied an update (mini_step back at 0): the ramp
    counts optimizer updates, not micro-steps, and a micro-step's decay is
    1.0 (EMA untouched). As JAX: 1 - applied * (1 - ema_decay(count))."""
    applied = 1.0 if opt_state.mini_step == 0 else 0.0
    upd = ema_updates + applied
    return 1.0 - applied * (1.0 - ema_decay(upd)), upd


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The BatchNorm running stats (the flax batch_stats collection)."""
    return {f"{m}.{b}" if m else b: t for m, mod in model.named_modules()
            if isinstance(mod, BatchNorm) for b, t in mod.named_buffers(recurse=False)}


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # the params and running stats, updated in place
    opt_state: AdamState
    ema_params: Dict[str, torch.Tensor]
    ema_batch_stats: Dict[str, torch.Tensor]
    step: int  # micro-steps taken
    ema_updates: torch.Tensor  # fp32 scalar: optimizer updates counted by the EMA ramp


def create_train_state(model: nn.Module, tx: AdamW, init_updates: int = 10560,
                       predicate: Callable[[Tuple[str, ...]], bool] = stage2_trainable
                       ) -> TrainState:
    """Freeze the params outside the trainable set (`predicate`, stage 2's
    by default; the optimizer sees only the others) with
    requires_grad=False, and start the optimizer, the EMA (copies of every
    param and running stat) and the counters: init_updates 10,560 for
    stage 2, 0 for stage 1, as JAX."""
    mask = trainable_mask(model, predicate)
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    with torch.no_grad():
        ema_p = {n: p.detach().clone() for n, p in model.named_parameters()}
        ema_b = {n: b.detach().clone() for n, b in batch_stats(model).items()}
    dev = next(model.parameters()).device
    return TrainState(model, tx.init(trainable_params(model)), ema_p, ema_b, 0,
                      torch.tensor(float(init_updates), dtype=torch.float32, device=dev))


def apply_gradients(tx: AdamW, state: TrainState, grads: Mapping[str, torch.Tensor],
                    params: Mapping[str, torch.Tensor], with_stats: bool = True) -> TrainState:
    """The optimizer micro-step and the gated EMA of the params (and, with
    with_stats, the running stats): the shared end of both stages' steps."""
    opt_state = tx.update(grads, state.opt_state, params)
    d, ema_updates = ema_step_fields(state.ema_updates, opt_state)
    if opt_state.mini_step == 0:  # decay 1.0 leaves the EMA as it is
        ema_update(state.ema_params, dict(state.model.named_parameters()), d)
        if with_stats:
            ema_update(state.ema_batch_stats, batch_stats(state.model), d)
    return dataclasses.replace(state, opt_state=opt_state, step=state.step + 1,
                               ema_updates=ema_updates)


def _no_mark(stage: str) -> None:
    pass


def loss_fn(model: VeonModel, cfg: VeonConfig, membership: np.ndarray, batch,
            mark: Callable[[str], None] = _no_mark) -> Dict[str, torch.Tensor]:
    """The stage-2 loss dict of one batch (train-mode forward; BatchNorm
    running stats move in place). Depth source priority: "depth", else
    "depth_preds", else the frozen depth tower on "depth_imgs"."""
    if "depth" in batch:
        depth = batch["depth"]
    elif "depth_preds" in batch:
        depth = batch["depth_preds"]
    else:
        with torch.no_grad():
            depth = model.estimate_depth(batch["depth_imgs"])
    mark("depth_tower")
    outputs = model(batch["imgs"], depth, batch["metas"], batch["ov_weight"], train=True)
    return occupancy_loss(outputs, batch["voxel_semantics"], batch["mask_camera"],
                          batch["metas"], batch["ov_weight"], membership, cfg.grid,
                          cfg.data.input_size, batch["epoch"], cfg.loss)


def make_train_step(model: VeonModel, tx: AdamW, cfg: VeonConfig, membership: np.ndarray,
                    mark: Callable[[str], None] = _no_mark):
    """step(state, batch) -> (state, losses): one stage-2 step on one
    device. batch: imgs (B,F,N,H,W,3), depth / depth_preds (B,F,N,H/2,W/2)
    or depth_imgs, metas, voxel_semantics / mask_camera (B,X,Y,Z),
    ov_weight, epoch. losses carry "loss_total". `mark(stage)` is called as
    each stage ends ("depth_tower", "forward_and_loss", "backward",
    "optimizer_and_ema"), e.g. to record a CUDA event there."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = trainable_params(model)
        losses = loss_fn(model, cfg, membership, batch, mark)
        total = sum(losses.values())
        mark("forward_and_loss")
        # a num_temporal > 1 model on current-frame batches (the epochs
        # before --temporal-start-epoch) leaves its temporal fusion unused:
        # zero gradient, as JAX's
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()),
                                                     allow_unused=True, materialize_grads=True)))
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss_total"] = total.detach()
        if collectives.data_parallel():
            grads = dict(zip(grads, collectives.all_reduce_mean(list(grads.values()))))
            losses = dict(zip(losses, collectives.all_reduce_mean(list(losses.values()))))
        mark("backward")
        state = apply_gradients(tx, state, grads, params)
        mark("optimizer_and_ema")
        return state, losses

    return step
