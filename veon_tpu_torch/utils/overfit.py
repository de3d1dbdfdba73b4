"""Single-batch overfit drills: the training recipe optimizes (counterpart
of `veon_tpu/utils/overfit.py`).

N real steps of the stage-1 or stage-2 step on one fixed tiny batch: the
loss must fall and, in stage 2, the eval-mode class grid move toward the
labels. A wrong schedule, trainable set, EMA gate or BatchNorm update
passes every one-step test and fails here. `bf16_divergence` runs the
bf16-vs-fp32 battery on the overfit (structured) weights.

    python -m veon_tpu_torch.utils.overfit --stage both --steps 60 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .. import resolve_device
from ..ckpt.from_jax import load_from_jax, variables_from_model
from ..ckpt.io import save_checkpoint
from ..cli.shapes import example_batch
from ..configs import presets
from ..configs.base import DepthConfig, GridConfig, LossConfig, ZoeConfig
from ..entry import build_model
from ..eval.miou import MIoUMetric
from ..eval.precision import precision_battery
from ..model.veon import VeonModel, fused_classes
from ..nn import text as text_mod
from ..nn.dpt import DepthAnythingV2
from ..nn.layers import init_random_
from ..nn.zoedepth import ZoeDepthNK
from ..train.depth_pretrain import depth_trainable, make_depth_pretrain_step, zoe_trainable
from ..train.step import AdamW, create_train_state, make_train_step

# the JAX drill's tiny zoe tower
TINY_ZOE = dict(width=32, depth=2, heads=2, patch_size=16, hooks=(0, 1, 1, 1),
                pyramid_channels=(8, 16, 16, 16), features=8, n_bins=6, bin_embedding_dim=8,
                n_attractors=(4, 2, 2, 1), lora_r=2)


def stage2_overfit(steps: int = 40, lr: float = 1e-3, warmup_iters: int = 5, seed: int = 0,
                   log_every: int = 10, ema_eval: bool = False, device="cuda",
                   variables: Optional[Mapping] = None, init_device=None) -> Dict:
    """`steps` stage-2 steps at `veon_tiny_test` (weights seeded by a
    generator on `init_device`, default `device`, or a JAX `variables`
    tree) on one batch with random labels over every voxel, all visible.
    The two devices' generators give different weights for one seed.
    Returns the
    loss_total curve [(step, loss)], the first and last loss dicts, the
    eval-mode accuracy and mIoU of the fusion-rule grid against the labels
    before and after (the EMA's with ema_eval), and the state, model, cfg,
    batch, vocabulary and labels."""
    dev = resolve_device(device)
    cfg = presets.veon_tiny_test()
    init = resolve_device(init_device) if init_device else dev
    if variables is None and init != dev:
        variables = variables_from_model(build_model(cfg, init, seed, None))
    model = build_model(cfg, dev, seed, variables)
    imgs, depth, metas = example_batch(cfg, device=dev)
    prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    rng = np.random.default_rng(seed)
    ovw = torch.from_numpy(rng.standard_normal(
        (len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)).to(dev)
    nx, ny, nz = cfg.grid.size
    gt = rng.integers(0, 18, size=(1, nx, ny, nz)).astype(np.int32)
    batch = {"imgs": imgs, "depth": depth, "metas": metas,
             "voxel_semantics": torch.from_numpy(gt).to(dev),
             "mask_camera": torch.ones(1, nx, ny, nz, dtype=torch.int32, device=dev),
             "ov_weight": ovw, "epoch": 0}
    membership = text_mod.merge_matrix(refl)
    tx = AdamW(lr=lr, warmup_iters=warmup_iters)
    state = create_train_state(model, tx, init_updates=0)
    step = make_train_step(model, tx, cfg, membership)

    @torch.no_grad()
    def score(m):
        pred = fused_classes(m(imgs, depth, metas, ovw), membership).cpu().numpy()
        metric = MIoUMetric(use_image_mask=True)
        metric.add_batch(pred, gt, None, np.ones_like(gt))
        return float((pred == gt).mean()), float(metric.count_miou()[2])

    acc0, miou0 = score(model)
    curve, first, last = [], {}, {}
    for i in range(steps):
        state, losses = step(state, batch)
        if i == 0 or (i + 1) % log_every == 0 or i == steps - 1:
            last = {k: float(v) for k, v in losses.items()}
            curve.append((i + 1, last["loss_total"]))
            first = first or last
    if ema_eval:
        shadow = build_model(cfg, dev, seed, None)
        shadow.load_state_dict({**state.ema_params, **state.ema_batch_stats})
        acc1, miou1 = score(shadow)
    else:
        acc1, miou1 = score(model)
    return {"curve": curve, "loss0": curve[0][1], "loss1": curve[-1][1], "acc0": acc0,
            "acc1": acc1, "miou0": miou0, "miou1": miou1, "first_losses": first,
            "final_losses": last, "state": state, "model": model, "cfg": cfg, "batch": batch,
            "refl": refl, "gt": gt}


def stage1_overfit(steps: int = 40, lr: float = 1e-3, warmup_iters: int = 5, seed: int = 0,
                   log_every: int = 10, depth_mode: str = "dav2", device="cuda",
                   variables: Optional[Mapping] = None) -> Dict:
    """`steps` stage-1 steps on one batch: the JAX drill's tiny DA-V2 (ViT-S,
    LoRA r=2, two 28x42 frames) or with depth_mode="zoe" its tiny
    ZoeDepth-NK (two 64x96 frames), seeded (or from a JAX `variables`
    tree), against a smooth road-like GT
    (depth growing with the row) that the adapters and head can fit.
    Returns the loss_total curve and the state."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    with torch.device(dev):
        if depth_mode == "zoe":
            tower, trainable, (H, W), (gh, gw) = (ZoeDepthNK(ZoeConfig(**TINY_ZOE), lora=True),
                                                  zoe_trainable, (64, 96), (64, 96))
        else:
            tower = DepthAnythingV2(DepthConfig(encoder="vits", features=8,
                                                out_channels=(4, 8, 8, 8), lora_r=2), lora=True)
            trainable, (H, W), (gh, gw) = depth_trainable, (28, 42), (32, 48)
    if variables is not None:
        load_from_jax(tower, variables)
    else:
        init_random_(tower, torch.Generator(device=dev).manual_seed(seed))
    imgs = torch.from_numpy(rng.standard_normal((1, 1, 2, H, W, 3)).astype(np.float32)).to(dev)
    yy, xx = np.meshgrid(np.linspace(0, 1, gh), np.linspace(0, 1, gw), indexing="ij")
    plane = 4.0 + 30.0 * yy + 5.0 * xx
    gt = torch.from_numpy(np.stack([plane, plane[::-1]])[None].astype(np.float32)).to(dev)
    tx = AdamW(lr=lr, warmup_iters=warmup_iters)
    state = create_train_state(tower, tx, init_updates=0, predicate=trainable)
    step = make_depth_pretrain_step(tower, tx, GridConfig(), LossConfig())
    batch = {"depth_imgs": imgs, "gt_depth": gt}
    curve = []
    for i in range(steps):
        state, losses = step(state, batch)
        if i == 0 or (i + 1) % log_every == 0 or i == steps - 1:
            curve.append((i + 1, float(losses["loss_total"])))
    return {"curve": curve, "loss0": curve[0][1], "loss1": curve[-1][1], "state": state}


@torch.no_grad()
def bf16_divergence(model: VeonModel, cfg, state, batch, refl) -> Dict[str, float]:
    """The bf16-vs-fp32 battery (`eval/precision.py`) on `model`'s (e.g.
    overfit) weights and `batch`'s inputs."""
    dev = batch["imgs"].device
    low = VeonModel(dataclasses.replace(cfg, compute_dtype="bfloat16"), device=dev)
    low.load_state_dict(model.state_dict())
    args = (batch["imgs"], batch["depth"], batch["metas"], batch["ov_weight"])
    return precision_battery(model(*args), low(*args), text_mod.merge_matrix(refl))


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--stage", choices=("1", "2", "both"), default="both")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, nargs="+", default=[0],
                    help="one drill (and one report) per seed")
    ap.add_argument("--bf16-divergence", action="store_true",
                    help="the precision battery on the overfit stage-2 weights")
    ap.add_argument("--save", default=None, help="work_dir for the overfit stage-2 checkpoint")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    ap.add_argument("--init-device", default=None,
                    help="the device whose generator seeds the stage-2 weights (default --device)")
    args = ap.parse_args(argv)
    reports = []
    for seed in args.seed:
        report = {"seed": seed}
        if args.stage in ("1", "both"):
            r1 = stage1_overfit(steps=args.steps, lr=args.lr, seed=seed,
                                log_every=args.log_every, device=args.device)
            report["stage1"] = {k: r1[k] for k in ("curve", "loss0", "loss1")}
            report["stage1"]["drop_pct"] = 100 * (1 - r1["loss1"] / r1["loss0"])
        if args.stage in ("2", "both"):
            r2 = stage2_overfit(steps=args.steps, lr=args.lr, seed=seed,
                                log_every=args.log_every, device=args.device,
                                init_device=args.init_device)
            report["stage2"] = {k: r2[k] for k in ("curve", "loss0", "loss1", "acc0", "acc1",
                                                   "miou0", "miou1", "first_losses",
                                                   "final_losses")}
            report["stage2"]["drop_pct"] = 100 * (1 - r2["loss1"] / r2["loss0"])
            if args.bf16_divergence:
                report["bf16_overfit"] = bf16_divergence(r2["model"], r2["cfg"], r2["state"],
                                                         r2["batch"], r2["refl"])
            if args.save:
                work = args.save if len(args.seed) == 1 else os.path.join(args.save,
                                                                          f"seed_{seed}")
                report["saved"] = save_checkpoint(work, r2["state"].step, r2["state"])
        print(json.dumps(report, indent=None if args.json else 2))
        reports.append(report)
    return reports


if __name__ == "__main__":
    main()
