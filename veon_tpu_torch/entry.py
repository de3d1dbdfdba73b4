"""Serving entry of the port: the VEON-B F=1 forward from camera images to
the class grid (counterpart of `__graft_entry__.entry`).

    forward, (imgs, depth_imgs) = entry()      # veon_b, bf16, on the card
    grid = forward(imgs, depth_imgs)           # (1, 200, 200, 16) int32

The rig is fixed, so its rank sort is precomputed once here
(`LSSLift.precompute_sorted`) and each frame runs no sort.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from . import resolve_device
from .cli.shapes import example_batch_full
from .ckpt.from_jax import load_from_jax
from .configs import presets
from .configs.base import VeonConfig
from .geometry.frustum import sensor2keyego_chain
from .model.veon import VeonModel, fusion_rule
from .nn import text as text_mod
from .nn.layers import init_random_


class FrameServer:
    """A built model with its rig precompute, vocabulary merge and
    open-vocabulary weights; calling it serves one frame."""

    def __init__(self, model: VeonModel, metas, ov_weight, membership):
        self.model, self.metas = model, metas
        self.ov_weight, self.membership = ov_weight, membership

    def outputs(self, imgs, depth_imgs):
        """The model's raw fp32 outputs (bin_occ, feat_occ, sem_occ_raw, ...)."""
        return self.model.full_forward(imgs, depth_imgs, self.metas, self.ov_weight)

    @torch.no_grad()
    def __call__(self, imgs, depth_imgs):
        out = self.outputs(imgs, depth_imgs)
        merged = text_mod.merge_classes_max(out["sem_occ_raw"], self.membership, axis=-1)
        return fusion_rule(merged, out["bin_occ"])


def entry(cfg: Optional[VeonConfig] = None, device="cuda", seed: int = 0,
          variables: Optional[Mapping] = None):
    """(forward, (imgs, depth_imgs)) for `cfg` (default: veon_b in bf16).

    Weights come from `variables` (a JAX variables tree as numpy arrays)
    when given, else from a seeded random initialisation; `ov_weight` is
    the numpy-seeded open-vocabulary matrix of the JAX entry."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = presets.veon_b(compute_dtype="bfloat16")
    if dev.type == "cuda":
        # fp32 stays fp32 where a config asks for it: no TF32 in convs or matmuls
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = VeonModel(cfg, device=dev).eval()
    if variables is not None:
        load_from_jax(model, variables)
    else:
        init_random_(model, torch.Generator(device=dev).manual_seed(seed))
    imgs, depth_imgs, metas = example_batch_full(cfg, device=dev)
    prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    rng = np.random.default_rng(1)
    ovw = torch.from_numpy(rng.standard_normal(
        (len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)).to(dev)
    F, N = metas["intrins"].shape[1:3]
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), F, N)
    metas = dict(metas)
    metas["lift_sorted"] = model.lift.precompute_sorted(
        s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0],
        metas["post_trans"][:, 0], metas["bda"])
    server = FrameServer(model, metas, ovw, text_mod.merge_matrix(refl))
    return server, (imgs, depth_imgs)
