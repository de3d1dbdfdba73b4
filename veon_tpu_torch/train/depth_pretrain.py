"""Stage-1 depth pretraining (counterpart of `veon_tpu/train/depth_pretrain.py`).

Trains the LoRA adapters and the DPT head of DepthAnythingV2 (or, on the
zoe branch, the adapters plus everything outside the BEiT trunk) against
LiDAR depth: SILog + 0.05 * bin-CE on min-pooled maps, with the trunk's
base weights frozen.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import GridConfig, LossConfig
from ..data.transforms import normalize_in_graph
from ..lift.lss import min_pool_depth
from ..ops.resize import resize_bilinear
from .losses import depth_pretrain_loss
from .step import AdamW, TrainState, apply_gradients, trainable_params

LORA = ("lora_A", "lora_B")


def depth_trainable(path: Tuple[str, ...]) -> bool:
    """DA-V2: the adapters and the whole DPT head train; the DINOv2 trunk is frozen."""
    return path[0] == "depth_head" or path[-1] in LORA


def zoe_trainable(path: Tuple[str, ...]) -> bool:
    """ZoeDepth-NK (the reference freezes what is named 'pretrain' but not
    'lora'): the BEiT trunk (under core.pretrained) is frozen but for its
    adapters; the readouts, the MiDaS decoder and the bins head train."""
    return path[-1] in LORA or "pretrained" not in path


def make_depth_pretrain_step(model: nn.Module, tx: AdamW, grid: GridConfig, cfg: LossConfig,
                             pred_downsample: int = 8, gt_downsample: int = 16,
                             norm_in_graph: Optional[str] = None):
    """step(state, batch) -> (state, losses): one stage-1 step. batch:
    depth_imgs (B, F, N, Hd, Wd, 3) of which frame 0 is used, gt_depth
    (B, N, H, W) at the full input resolution. The prediction is resized to
    H/2 x W/2 (bilinear, align_corners=True) where its size differs, then
    min-pooled by 8 and the GT by 16, so both land on one grid.
    `norm_in_graph` names the normalizer when the loader ships raw uint8
    frames. The EMA covers the tower's params (it has no running stats)."""

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = trainable_params(model)
        imgs = batch["depth_imgs"][:, 0]
        if norm_in_graph is not None:
            imgs = normalize_in_graph(imgs, norm_in_graph)
        B, N = imgs.shape[:2]
        gt = batch["gt_depth"]
        pred = model(imgs.reshape((-1,) + imgs.shape[2:]))
        h2, w2 = gt.shape[-2] // 2, gt.shape[-1] // 2
        if tuple(pred.shape[-2:]) != (h2, w2):
            pred = resize_bilinear(pred[..., None], (h2, w2), align_corners=True)[..., 0]
        pred = pred.reshape(B, N, h2, w2)
        losses = depth_pretrain_loss(min_pool_depth(pred, pred_downsample),
                                     min_pool_depth(gt, gt_downsample), grid, cfg)
        total = sum(losses.values())
        # zoe's relative-depth head (core.out_conv3) trains but feeds no
        # metric depth: its gradient is zero, as JAX's
        grads = dict(zip(params, torch.autograd.grad(total, list(params.values()),
                                                     allow_unused=True, materialize_grads=True)))
        state = apply_gradients(tx, state, grads, params, with_stats=False)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss_total"] = total.detach()
        return state, losses

    return step
