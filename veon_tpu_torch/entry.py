"""Entry points of the port, on the card unless device="cpu".

Serving, the VEON-B F=1 forward from camera images to the class grid
(counterpart of `__graft_entry__.entry`):

    forward, (imgs, depth_imgs) = entry()      # veon_b, bf16
    grid = forward(imgs, depth_imgs)           # (1, 200, 200, 16) int32

The rig is fixed, so its rank sort is precomputed once here
(`LSSLift.precompute_sorted`) and each frame runs no sort.

Temporal serving, a streaming session over a synthetic drive (counterpart
of `veon_tpu serve --num-temporal 2`, the flagship's temporal mode):

    session, frames = temporal_entry()         # veon_b, T=2, bf16
    for r in frames:                           # time order
        out = session.infer(r["imgs"], r["depth_imgs"],
                            {"lidarego2global": r["lidarego2global"]})
        out["pred"]                            # (1, 200, 200, 16) uint8

Each call lifts only its own frame (kernel #1 on the fixed rig) and fuses
the cached voxels of the previous num_temporal - 1 frames.

Training, the stage-2 step (counterpart of `make_train_step(mesh=None)` on
the synthetic batch of `veon_tpu/utils/train_bench.py` build_train_setup):

    trainer, batch = train_entry()             # veon_b, bf16
    losses = trainer(batch)                    # one step: dict of scalars

The batch carries depth_imgs, so the frozen depth tower runs in the step
(the flagship's no-depth-cache recipe); the lift is the banded one unless
cfg.lss_banded is False.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from . import resolve_device
from .cli.shapes import example_batch, example_batch_full, example_depth_imgs, example_drive
from .ckpt.from_jax import load_from_jax
from .configs import presets
from .configs.base import VeonConfig
from .geometry.frustum import sensor2keyego_chain
from .model.veon import VeonModel, fusion_rule
from .nn import text as text_mod
from .nn.layers import init_random_
from .serve.streaming import TemporalSession
from .train.step import AdamW, TrainState, create_train_state, make_train_step


class FrameServer:
    """A built model with its rig precompute, vocabulary merge and
    open-vocabulary weights; calling it serves one frame."""

    def __init__(self, model: VeonModel, metas, ov_weight, membership):
        self.model, self.metas = model, metas
        self.ov_weight, self.membership = ov_weight, membership

    @torch.no_grad()
    def outputs(self, imgs, depth_imgs):
        """The model's raw fp32 outputs (bin_occ, feat_occ, sem_occ_raw, ...)."""
        return self.model.full_forward(imgs, depth_imgs, self.metas, self.ov_weight)

    @torch.no_grad()
    def __call__(self, imgs, depth_imgs):
        out = self.outputs(imgs, depth_imgs)
        merged = text_mod.merge_classes_max(out["sem_occ_raw"], self.membership, axis=-1)
        return fusion_rule(merged, out["bin_occ"])


def _build_model(cfg, dev, seed, variables) -> VeonModel:
    """The model on `dev` with weights from `variables` (a JAX variables
    tree as numpy arrays) when given, else from a seeded random init."""
    if dev.type == "cuda":
        # fp32 stays fp32 where a config asks for it: no TF32 in convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = VeonModel(cfg, device=dev)
    if variables is not None:
        load_from_jax(model, variables)
    else:
        init_random_(model, torch.Generator(device=dev).manual_seed(seed))
    return model


def _ov_weight(cfg: VeonConfig, dev):
    """The numpy-seeded open-vocabulary matrix of the JAX entry and the
    vocabulary's merge matrix."""
    prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    rng = np.random.default_rng(1)
    ovw = torch.from_numpy(rng.standard_normal(
        (len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)).to(dev)
    return ovw, text_mod.merge_matrix(refl)


def _with_presort(model: VeonModel, metas):
    """The rig metas plus the fixed rig's presorted lift streams
    ("lift_sorted"), from frame 0's geometry."""
    F, N = metas["intrins"].shape[1:3]
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), F, N)
    metas = dict(metas)
    metas["lift_sorted"] = model.lift.precompute_sorted(
        s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0],
        metas["post_trans"][:, 0], metas["bda"])
    return metas


def entry(cfg: Optional[VeonConfig] = None, device="cuda", seed: int = 0,
          variables: Optional[Mapping] = None):
    """(forward, (imgs, depth_imgs)) for `cfg` (default: veon_b in bf16);
    `ov_weight` is the numpy-seeded open-vocabulary matrix of the JAX entry."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = presets.veon_b(compute_dtype="bfloat16")
    model = _build_model(cfg, dev, seed, variables)
    imgs, depth_imgs, metas = example_batch_full(cfg, device=dev)
    ovw, membership = _ov_weight(cfg, dev)
    return FrameServer(model, _with_presort(model, metas), ovw, membership), (imgs, depth_imgs)


def temporal_entry(cfg: Optional[VeonConfig] = None, device="cuda", seed: int = 0,
                   variables: Optional[Mapping] = None, num_temporal: int = 2,
                   frames: int = 4):
    """(session, requests): a `TemporalSession` for `cfg` (default: veon_b
    with `num_temporal` frames, bf16) whose rig metas carry the fixed rig's
    presorted lift, and `frames` requests of the seeded synthetic drive
    (`cli/shapes.py` `example_drive`), in time order."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = presets.veon_b(num_temporal=num_temporal, compute_dtype="bfloat16")
    model = _build_model(cfg, dev, seed, variables)
    rig, requests = example_drive(cfg, frames, device=dev, seed=seed)
    ovw, membership = _ov_weight(cfg, dev)
    return TemporalSession(model, ovw, membership, rig_metas=_with_presort(model, rig)), requests


class Trainer:
    """A model in training with its optimizer state; calling it takes one
    stage-2 step on a batch and returns the losses."""

    def __init__(self, model: VeonModel, state: TrainState, step, membership):
        self.model, self.state, self.step, self.membership = model, state, step, membership

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        self.state, losses = self.step(self.state, batch)
        return losses


def train_batch(cfg: VeonConfig, device="cuda") -> Dict:
    """The synthetic stage-2 batch: the example rig and images, depth_imgs
    for the frozen depth tower, the seeded open-vocabulary matrix and
    random voxel labels (both from default_rng(7)), every voxel visible,
    epoch 0."""
    imgs, _depth, metas = example_batch(cfg, device=device)
    prompts, _refl = text_mod.build_vocabulary(cfg.vocabulary)
    rng = np.random.default_rng(7)
    ovw = rng.standard_normal((len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)
    nx, ny, nz = cfg.grid.size
    labels = rng.integers(0, 18, size=(1, nx, ny, nz)).astype(np.int32)
    return {"imgs": imgs, "depth_imgs": example_depth_imgs(cfg, device=device), "metas": metas,
            "voxel_semantics": torch.from_numpy(labels).to(device),
            "mask_camera": torch.ones(1, nx, ny, nz, dtype=torch.int32, device=device),
            "ov_weight": torch.from_numpy(ovw).to(device), "epoch": 0}


def train_entry(cfg: Optional[VeonConfig] = None, device="cuda", seed: int = 0,
                variables: Optional[Mapping] = None):
    """(trainer, batch) for `cfg` (default: veon_b in bf16): the stage-2
    trainable set (hsa, lift_fusion, alignnet), AdamW with warmup and the
    EMA from 10,560 updates, as `veon_tpu/train/step.py`."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = presets.veon_b(compute_dtype="bfloat16")
    model = _build_model(cfg, dev, seed, variables)
    _prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    membership = text_mod.merge_matrix(refl)
    tx = AdamW()
    state = create_train_state(model, tx)
    return (Trainer(model, state, make_train_step(model, tx, cfg, membership), membership),
            train_batch(cfg, device=dev))
