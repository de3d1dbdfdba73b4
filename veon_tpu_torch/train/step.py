"""The stage-2 train step on one device (counterpart of
`veon_tpu/train/step.py` with mesh=None): forward with train-mode
BatchNorm, the occupancy loss, the backward, AdamW with global-norm
clipping and linear warmup over the trainable params only, and the EMA of
params and BatchNorm running stats.

Params and running stats live in the model and are updated in place; the
optimizer moments, the EMA copies and the counters live in `TrainState`.
The optimizer is optax's chain written out by hand, rule for rule:
clip_by_global_norm (t / norm * max_norm when norm >= max_norm; no
epsilon, unlike torch's clip_grad_norm_), adamw (bias-corrected moments,
decay added to the Adam direction) and a schedule read at the count
BEFORE the step's increment.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..configs.base import VeonConfig
from ..model.veon import VeonModel
from .losses import occupancy_loss

# CLIP towers, side adapter and depth tower are frozen in stage 2; the
# effective trainable set is hsa / lift_fusion / alignnet.
STAGE2_FROZEN_PREFIXES = ("depth", "side_adapter", "clip_visual", "rec_head")


def stage2_trainable(path: Tuple[str, ...]) -> bool:
    return path[0] not in STAGE2_FROZEN_PREFIXES


def trainable_params(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if stage2_trainable(tuple(n.split(".")))}


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW(lr 1e-4, wd 1e-2) after a global-norm clip at 5, with a linear
    warmup from lr * warmup_ratio over warmup_iters steps."""

    lr: float = 1e-4
    weight_decay: float = 1e-2
    warmup_iters: int = 200
    warmup_ratio: float = 1e-3
    max_norm: float = 5.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        return AdamState(0, {n: torch.zeros_like(p) for n, p in params.items()},
                         {n: torch.zeros_like(p) for n, p in params.items()})

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
        """One step, applied to `params` in place; returns the new state."""
        names = list(params)
        dev = params[names[0]].device
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
        return AdamState(count, state.mu, state.nu)


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


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The BatchNorm running stats (the flax batch_stats collection)."""
    return dict(model.named_buffers())


@dataclasses.dataclass
class TrainState:
    opt_state: AdamState
    ema_params: Dict[str, torch.Tensor]
    ema_batch_stats: Dict[str, torch.Tensor]
    step: int
    ema_updates: torch.Tensor  # fp32 scalar: optimizer updates counted by the EMA ramp


def create_train_state(model: nn.Module, tx: AdamW, init_updates: int = 10560) -> TrainState:
    """Freeze the params outside the stage-2 trainable set
    (requires_grad=False) and start the optimizer, the EMA (copies of every
    param and running stat) and the counters."""
    train = trainable_params(model)
    for n, p in model.named_parameters():
        p.requires_grad_(n in train)
    with torch.no_grad():
        ema_p = {n: p.detach().clone() for n, p in model.named_parameters()}
        ema_b = {n: b.detach().clone() for n, b in batch_stats(model).items()}
    dev = next(model.parameters()).device
    return TrainState(tx.init(train), ema_p, ema_b, 0,
                      torch.tensor(float(init_updates), dtype=torch.float32, device=dev))


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
    params = trainable_params(model)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        losses = loss_fn(model, cfg, membership, batch, mark)
        total = sum(losses.values())
        mark("forward_and_loss")
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
        mark("backward")
        opt_state = tx.update(grads, state.opt_state, params)
        ema_updates = state.ema_updates + 1.0
        d = ema_decay(ema_updates)
        ema_update(state.ema_params, dict(model.named_parameters()), d)
        ema_update(state.ema_batch_stats, batch_stats(model), d)
        mark("optimizer_and_ema")
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss_total"] = total.detach()
        return TrainState(opt_state, state.ema_params, state.ema_batch_stats, state.step + 1,
                          ema_updates), losses

    return step

