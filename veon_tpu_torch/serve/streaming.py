"""Stateful streaming temporal serving (counterpart of
`veon_tpu/serve/streaming.py` `TemporalSession`).

The batched temporal forward lifts every previous frame again on each
call. A session does not: each call returns its frame's pre-fusion lifted
voxels (`early_vox`), the session caches them with the frame's ego pose
and replays them as the previous frames of the next call. A steady call
costs one frame's towers and lift plus (F-1) x (ego-motion warp +
temporal fusion), and its outputs equal the batched forward's on the same
frames.

Camera-sharded (`cam_group`): each rank runs its block of the cameras,
the lift sums the ranks' grids (`model/camshard.py`), and the cache,
which holds voxels after that sum, is the same on every rank. The rig
metas carry the stacked per-shard presort and the whole rig's keyego
anchor (`prepare_camshard_metas(presort=True)`); a frame's metas without
the anchor get it pinned before they are cut.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .. import torch_dtype
from ..collectives import CamGroup
from ..data.transforms import normalize_in_graph
from ..model.veon import VeonModel, fusion_rule, retrieval_map
from ..nn import text as text_mod
from ..model.camshard import gather_outputs, local_inputs, prepare_camshard_metas
from ..utils import tracing


class StreamingStep(nn.Module):
    """The stateless streaming serving step (counterpart of JAX's
    `TemporalSession._fn`, without `variables`): (imgs, depth_imgs, metas,
    ov_weight, prev_vox, prev_l2g, text_embed) -> the model's outputs plus
    `pred` (the uint8 (1, X, Y, Z) class grid, with a membership matrix),
    `retrieval` (the free-text map of text_embed; all zero for a zero
    embedding) and `early_vox` (this frame's voxels for the next call's
    cache, in the compute dtype). The cache rides in as prev_vox /
    prev_l2g, so the step holds no state and `utils/export.py` can freeze
    it; `TemporalSession` keeps the cache around it.
    `normalize=(img_method, depth_method)` takes raw uint8 HWC frames and
    normalizes them in the graph; `estimate_depth=False` takes metric depth
    in place of depth-tower images."""

    def __init__(self, model: VeonModel, membership=None, estimate_depth: bool = True,
                 normalize=None):
        super().__init__()
        self.model, self.membership = model, membership
        self.estimate_depth, self.normalize = estimate_depth, normalize

    def forward(self, imgs, depth_imgs, metas, ov_weight, prev_vox, prev_l2g, text_embed):
        if self.normalize is not None:
            with tracing.span("session.normalize"):
                imgs = normalize_in_graph(imgs, self.normalize[0])
                if self.estimate_depth:
                    depth_imgs = normalize_in_graph(depth_imgs, self.normalize[1])
        run = (self.model.full_forward_streaming if self.estimate_depth
               else self.model.forward_streaming)
        out = run(imgs, depth_imgs, metas, ov_weight, prev_vox, prev_l2g)
        if self.membership is not None:
            with tracing.span("session.merge"):
                merged = text_mod.merge_classes_max(out["sem_occ_raw"], self.membership, axis=-1)
                out["pred"] = fusion_rule(merged, out["bin_occ"]).to(torch.uint8)
        out["retrieval"] = retrieval_map(out["feat_occ"], text_embed)
        return out


class TemporalSession:
    """The last (num_temporal - 1) frames' early voxels and ego poses of one
    ego vehicle (B=1), newest first (slot 0 is frame t-1); `infer` serves
    one frame through the session's `StreamingStep` (`step`) and rolls the
    cache.

    Frames arrive in time order. The cache starts at zero voxels and
    identity poses, so the first num_temporal - 1 calls fuse against zero
    previous frames; steady state begins at call num_temporal.
    `estimate_depth=False` takes metric depth in place of depth-tower
    images; `normalize=(img_method, depth_method)` takes raw uint8 HWC
    frames and normalizes them on the card (`data/transforms.py`).
    `cam_group` shards the cameras over its ranks (the model in place,
    `VeonModel.set_cam_group`); every rank of the group calls `infer` with
    the whole frame.
    """

    def __init__(self, model: VeonModel, ov_weight: torch.Tensor, membership=None,
                 rig_metas: Optional[Dict[str, Any]] = None, estimate_depth: bool = True,
                 normalize=None, cam_group: Optional[CamGroup] = None):
        cfg = model.cfg
        if cfg.num_temporal < 2:
            raise ValueError("TemporalSession needs cfg.num_temporal >= 2")
        if cam_group is not None:
            model.set_cam_group(cam_group)
        self.cam_group = cam_group
        self.model, self.ov_weight, self.membership = model, ov_weight, membership
        self.rig_metas = dict(rig_metas or {})
        self.step = StreamingStep(model, membership, estimate_depth, normalize)
        dev = ov_weight.device
        nx, ny, nz = cfg.grid.size
        dz, dy, dx = cfg.lss_feat_ds
        T = cfg.num_temporal - 1
        self._vox = torch.zeros((1, T, nz // dz, ny // dy, nx // dx, cfg.propagation.dim),
                                dtype=torch_dtype(cfg.compute_dtype), device=dev)
        self._l2g = torch.eye(4, device=dev).expand(1, T, 4, 4).clone()
        self._zero_embed = torch.zeros(cfg.propagation.clip_proj_dim, device=dev)
        self.calls = 0

    @torch.no_grad()
    def infer(self, imgs, depth_imgs, metas, text_embed=None) -> Dict[str, torch.Tensor]:
        """One temporal step. imgs (1, 1, N, H, W, 3) and depth_imgs (or
        metric depth) of one frame; metas: this frame's lidarego2global
        (1, 4, 4) and any rig keys that differ from the session's
        `rig_metas` (which carry the presorted lift). text_embed (C,) adds a
        free-text `retrieval` map. Returns the model's outputs, `pred` (the
        uint8 (1, X, Y, Z) class grid, when the session has a membership
        matrix) and `retrieval`."""
        with tracing.span("session.infer"):
            m = dict(self.rig_metas)
            m.update(metas)
            te = self._zero_embed if text_embed is None else torch.as_tensor(
                text_embed, dtype=torch.float32, device=self._zero_embed.device)
            cg = self.cam_group
            if cg is not None:
                if "sensor2keyegos" not in m:
                    keep = m.pop("lift_sorted", None)
                    m = prepare_camshard_metas(self.model.cfg, m, cg.size)
                    if keep is not None:
                        m["lift_sorted"] = keep
                imgs, depth_imgs, m = local_inputs(imgs, depth_imgs, m, cg)
            out = self.step(imgs, depth_imgs, m, self.ov_weight, self._vox, self._l2g, te)
            if cg is not None:
                out = gather_outputs(out, cg)
            with tracing.span("session.cache"):
                early = out.pop("early_vox")
                l2g = m["lidarego2global"].to(torch.float32)
                self._vox = torch.cat([early[:, None].to(self._vox.dtype), self._vox[:, :-1]], 1)
                self._l2g = torch.cat([l2g[:, None], self._l2g[:, :-1]], 1)
            self.calls += 1
            return out

    def reset(self) -> None:
        """Zero the cache (a scene cut or a new sequence)."""
        self._vox = torch.zeros_like(self._vox)
        self._l2g = torch.eye(4, device=self._l2g.device).expand_as(self._l2g).clone()
        self.calls = 0

    def state(self):
        """(prev_vox, prev_lidarego2global), newest first."""
        return self._vox, self._l2g

    def load_state(self, vox, l2g, calls: Optional[int] = None) -> None:
        """Restore a cache saved by `state`; pass the saved `calls` to keep
        the cold-start count consistent with it."""
        if tuple(vox.shape) != tuple(self._vox.shape):
            raise ValueError(f"vox shape {tuple(vox.shape)} != {tuple(self._vox.shape)}")
        if tuple(l2g.shape) != tuple(self._l2g.shape):
            raise ValueError(f"l2g shape {tuple(l2g.shape)} != {tuple(self._l2g.shape)}")
        self._vox = torch.as_tensor(vox).to(self._vox.device, self._vox.dtype)
        self._l2g = torch.as_tensor(l2g).to(self._l2g.device, torch.float32)
        if calls is not None:
            self.calls = int(calls)
