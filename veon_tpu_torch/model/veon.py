"""The VEON graph for serving (F=1, batched F>1 and streaming temporal)
and for the stage-2 train step (counterpart of `veon_tpu/model/veon.py`
`VeonModel.full_forward`, `__call__`, `_forward_current`, `_early_vox`,
`forward_early`, `forward_streaming`, `full_forward_streaming`,
`align_to_prev`, `semantic_inference_2d`, `retrieval_map` and
`fusion_rule`).

Layout as on the JAX side: frame-major (B, F, N, ...) batches, channel-last
images and voxels, voxel outputs (B, Z, Y, X, C). Params are fp32; the
towers compute in `cfg.compute_dtype`; outputs are fp32.

The lift: a fixed rig's presorted streams when `metas` carry "lift_sorted"
(serving F=1, and the current frame of a streaming call), else
`cfg.lss_banded` picks the banded lift from metric depth (the training
default, and every frame of the batched F>1 forward) or the reference
full-frustum lift.

Camera sharding (`set_cam_group`, JAX's `cam_axis_name`): the model runs on
one rank's block of the cameras, and its lift sums the ranks' grids before
the max-pool (`lift/lss.py`); everything before the lift is per camera and
everything after it sees the same grid on every rank. The keyego anchor
is the rig's cam 0, which a shard whose first camera is another cannot
compute, so `metas["sensor2keyegos"]`, pinned from the whole rig
(`model/camshard.py` `prepare_camshard_metas`), is taken where present
(`resolve_sensor2keyegos`).

Temporal (F>1, frame 0 current, frames 1.. previous): each previous frame
is lifted with its own metas and no gradient, warped into the current
ego frame (`align_to_prev`) and fused before the 3D ResBlocks. The
streaming form takes the previous frames' lifted voxels from a cache
(`serve/streaming.py`) instead of recomputing them. In training the
previous frames stay outside the gradient (JAX's stop_gradient of their
voxels) while the temporal fusion, which takes them, trains on all frames.

train=True mirrors the reference's stage-2 no-grad boundary: the depth
tower, the CLIP trunk features and the side adapter / rec-head outputs are
computed without gradient; the deep-CLIP rerun inside the lift path
(`rec_head.update_remaining`) is NOT, so HSA's gradient flows through the
frozen rec head's blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from .. import resolve_device, torch_dtype
from ..collectives import CamGroup
from ..configs.base import VeonConfig
from ..geometry.frustum import _matvec, compose_se3, se3_inverse, sensor2keyego_chain
from ..lift.lss import LSSLift, min_pool_depth, two_hot_depth
from ..nn.alignnet import AlignNet3D, LiftFusion
from ..nn.dpt import DepthAnythingV2
from ..nn.hsa import HighresSideAdaptor
from ..nn.rematutil import RematSpec, check_policy
from ..nn.san import SideAdapterNetwork
from ..nn.text import merge_classes_max
from ..nn.vit import CLIPRecHead, CLIPVisualExtractor
from ..nn.zoedepth import ZoeDepthNK
from ..ops.grid_sample import grid_sample_3d
from ..ops.resize import resize_bilinear, resize_trilinear
from ..utils import graphs, tracing

# the per-camera (B, N, ...) output leaves, gathered over the cam group by
# camera-sharded serving and before the sharded step's loss; the voxel
# leaves are the same on every rank of a cam group
PER_CAMERA_OUTPUTS = ("sem_seg_ds", "sem_embed_ds", "clip_feat")
VOXEL_OUTPUTS = ("bin_occ", "feat_occ", "sem_occ_raw")


def resolve_sensor2keyegos(metas, B, F, N):
    """The per-frame keyego chain (B, F, N, 4, 4): metas["sensor2keyegos"]
    where pinned (a camera shard's), else computed from the batch's own
    sensor2egos / ego2globals, each frame anchored at its own cam-0 ego."""
    if "sensor2keyegos" in metas:
        return metas["sensor2keyegos"]
    return sensor2keyego_chain(metas["sensor2egos"].reshape(B, F * N, 4, 4),
                               metas["ego2globals"].reshape(B, F * N, 4, 4), F, N)


class VeonModel(nn.Module):
    """End-to-end VEON inference graph. Submodules carry the flax module
    names, so `ckpt/from_jax.py` maps a JAX variables tree onto them."""

    def __init__(self, cfg: VeonConfig, device="cuda", remat: RematSpec = False):
        super().__init__()
        c = self.cfg = cfg
        # recompute in the backward (`nn/rematutil.py`): the CLIP trunk, SAN,
        # rec head, HSA and AlignNet's ResBlocks, one block per region
        self.remat = check_policy(remat)
        dt = torch_dtype(c.compute_dtype)
        with torch.device(resolve_device(device)):
            if c.depth_mode == "zoedepth":
                self.depth = ZoeDepthNK(c.zoe, dtype=dt)
            else:
                self.depth = DepthAnythingV2(c.depth, dtype=dt)
            # layers consumed downstream: side-adapter and HSA fusion
            # sources and the rec-head entry layer
            save_layers = tuple(sorted(
                {cl for _, cl in c.san.fusion_map}
                | {ca for _, ca, _ad in c.hsa.fusion_map}
                | {ad for _, _ca, ad in c.hsa.fusion_map}
                | {c.san.feature_last_layer_idx}))
            self.clip_visual = CLIPVisualExtractor(
                c.san.clip_width, c.san.clip_heads, c.san.feature_last_layer_idx,
                c.san.clip_patch_size, c.san.clip_pretrain_grid, save_layers, dtype=dt,
                remat=remat)
            self.side_adapter = SideAdapterNetwork(c.san, dtype=dt, remat=remat)
            self.rec_head = CLIPRecHead(
                c.san.clip_width, c.san.clip_heads, c.san.feature_last_layer_idx,
                c.san.clip_layers, c.san.clip_embed_dim, c.san.num_queries,
                c.san.rec_downsample_method, c.san.rec_cross_attn, dtype=dt, remat=remat)
            self.hsa = HighresSideAdaptor(c.hsa, dtype=dt, remat=remat)
            self.lift_fusion = LiftFusion(c.propagation, c.hsa.manip_supp_dim,
                                          c.san.clip_width, dtype=dt)
            self.alignnet = AlignNet3D(c.propagation, c.propagation.clip_proj_dim,
                                       c.num_temporal, dtype=dt, remat=remat)
        self.lift = LSSLift.from_config(c)

    @property
    def cam_group(self) -> Optional[CamGroup]:
        return self.lift.cam_group

    def set_cam_group(self, cam_group: Optional[CamGroup]) -> "VeonModel":
        """Shard the cameras over `cam_group` (None: every camera local), in
        place; the weights stay as they are. Returns the model."""
        self.lift = dataclasses.replace(self.lift, cam_group=cam_group)
        return self

    def estimate_depth(self, depth_imgs):
        """(B, F, N, Hd, Wd, 3) DA-V2- or midas-normalized (the depth
        branch's) -> (B, F, N, H/2, W/2) metric, resized bilinear
        align_corners=True."""
        B, F, N = depth_imgs.shape[:3]
        with tracing.span("model.depth"):
            d = self.depth(depth_imgs.reshape((-1,) + depth_imgs.shape[3:]))
            h2, w2 = self.cfg.data.input_size[0] // 2, self.cfg.data.input_size[1] // 2
            if tuple(d.shape[-2:]) != (h2, w2):
                d = resize_bilinear(d[..., None], (h2, w2), align_corners=True)[..., 0]
        return d.reshape((B, F, N) + d.shape[1:])

    def full_forward(self, imgs, depth_imgs, metas, ov_weight, train: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """Depth estimation (always without gradient) + semantic forward."""
        with torch.no_grad():
            depth = self.estimate_depth(depth_imgs)
        return self(imgs, depth, metas, ov_weight, train=train)

    def forward(self, imgs, depth, metas, ov_weight, train: bool = False,
                return_early_vox: bool = False) -> Dict[str, torch.Tensor]:
        """imgs (B, F, N, H, W, 3); depth (B, F, N, H/2, W/2) metric; metas
        with the rig (sensor2egos, ego2globals, intrins, post_rots,
        post_trans, bda), optionally "lift_sorted" from
        `LSSLift.precompute_sorted` (used at F=1) and a pinned
        "sensor2keyegos" (B, F, N, 4, 4), and for F>1
        lidarego2global (B, 4, 4) and prev_lidarego2global (B, F-1, 4, 4);
        ov_weight (P+1, C_embed). Returns sem_seg_ds / sem_embed_ds
        (B,N,h,w,C), clip_feat, bin_occ (B,Z,Y,X,2), feat_occ, sem_occ_raw
        (B,Z,Y,X,P+1), and with return_early_vox the current frame's
        pre-fusion voxels in the compute dtype."""
        B, F, N = imgs.shape[:3]
        flat = imgs.reshape((-1,) + imgs.shape[3:])
        with _frozen(train):
            feats = self._clip_trunk(flat)  # every frame's cameras
        s2k = resolve_sensor2keyegos(metas, B, F, N)

        def frame_flat(x, f):
            return x.reshape((B, F, N) + x.shape[1:])[:, f].reshape((B * N,) + x.shape[1:])

        def lift_args(f):
            return (s2k[:, f], metas["intrins"][:, f], metas["post_rots"][:, f],
                    metas["post_trans"][:, f], metas["bda"])

        prevs = []
        for f in range(1, F):
            with torch.no_grad():
                vox, _ = self._early_vox(frame_flat(flat, f),
                                         {k: frame_flat(v, f) for k, v in feats.items()},
                                         depth[:, f], lift_args(f))
                with tracing.span("model.warp"):
                    prevs.append(self.align_to_prev(vox, metas["lidarego2global"],
                                                    metas["prev_lidarego2global"][:, f - 1]))
        if F > 1:
            flat, feats = frame_flat(flat, 0), {k: frame_flat(v, 0) for k, v in feats.items()}
        return self._forward_current(flat, feats, depth[:, 0], ov_weight, B, N, lift_args(0),
                                     metas.get("lift_sorted") if F == 1 else None, train,
                                     prevs, return_early_vox)

    def _forward_current(self, flat0, feats, depth0, ov_weight, B, N, lift_args, presorted,
                         train: bool = False, occ_feat_prevs=(), return_early_vox: bool = False):
        """The current frame's decode, lift and 3D head, shared by the
        batched forward and the streaming path; occ_feat_prevs are the
        previous frames' voxels already warped into this frame's ego."""
        c = self.cfg
        with _frozen(train):
            with tracing.span("model.side_adapter"):
                mask_preds, attn_bias, _ = self.side_adapter(flat0, feats)
            with tracing.span("model.rec_head"):
                mask_embs = self.rec_head(feats, attn_bias, normalize=True)
        vox, feats_0 = self._early_vox(flat0, feats, depth0, lift_args, presorted)
        with tracing.span("model.alignnet"):
            occ = self.alignnet(vox, list(occ_feat_prevs), train=train)
        # the outputs: voxels up to the full grid, the vocabulary's logits,
        # the 2D semantic maps, fp32
        with tracing.span("model.output"):
            nx, ny, nz = c.grid.size
            feat_occ = resize_trilinear(occ["feat_occ"], (nz, ny, nx))
            bin_occ = resize_trilinear(occ["bin_occ"], (nz, ny, nx))
            sem_occ_raw = feat_occ @ ov_weight.to(feat_occ.dtype).T
            mask_logits = mask_embs @ ov_weight.to(mask_embs.dtype).T
            sem_seg_ds, sem_embed_ds = self.semantic_inference_2d(mask_logits, mask_embs,
                                                                  mask_preds)
            proj = feats_0["clip_feat_proj"]
            out = {
                "sem_seg_ds": sem_seg_ds.reshape((B, N) + sem_seg_ds.shape[1:]),
                "sem_embed_ds": sem_embed_ds.reshape((B, N) + sem_embed_ds.shape[1:]),
                "clip_feat": proj.reshape((B, N) + proj.shape[1:]),
                "bin_occ": bin_occ, "feat_occ": feat_occ, "sem_occ_raw": sem_occ_raw,
            }
            out = {k: v.float() for k, v in out.items()}
        if return_early_vox:
            # compute dtype: it is the next call's cached previous frame
            out["early_vox"] = vox.detach()
        return out

    def _early_vox(self, flat_imgs, feats, depth_f, lift_args, presorted=None):
        """HSA + deep-CLIP rerun + fuse + LSS lift for one frame.
        flat_imgs (B*N, H, W, 3); depth_f (B, N, H/2, W/2)."""
        c = self.cfg
        with tracing.span("model.hsa"):
            attns, supp = self.hsa(flat_imgs, feats)
        with tracing.span("model.rec_rerun"):
            feats = self.rec_head.update_remaining(feats, attns)
        with tracing.span("model.lift"):
            vox = graphs.region("lift", self._lift, supp, feats[str(c.san.clip_layers)], depth_f,
                                lift_args, presorted)
        return vox, feats

    def _lift(self, supp, clip, depth_f, lift_args, presorted):
        """The lift's input projection of (supp, clip) and the lift of one
        frame's cameras on its metric depth depth_f (B, N, H/2, W/2)."""
        c = self.cfg
        B, N = depth_f.shape[:2]
        lift_hw = (c.data.input_size[0] // c.lss_downsample,
                   c.data.input_size[1] // c.lss_downsample)
        fused = self.lift_fusion(supp, clip, lift_hw)
        fused = fused.reshape((B, N) + fused.shape[1:])
        d_ds = min_pool_depth(depth_f, 8)
        if presorted is not None:
            return self.lift.lift_presorted(fused, two_hot_depth(d_ds, c.grid), presorted)
        if c.lss_banded:
            return self.lift.lift_from_metric(fused, d_ds, *lift_args)
        return self.lift(fused, two_hot_depth(d_ds, c.grid), *lift_args)

    def forward_early(self, imgs, depth, metas):
        """One frame's early pipeline for the streaming cache (CLIP trunk,
        HSA, deep-CLIP rerun, fuse, lift) in its own ego frame: imgs
        (B, 1, N, H, W, 3), depth (B, 1, N, H/2, W/2), the frame's own F=1
        metas -> vox (B, Zf, Yf, Xf, C), what the batched forward computes
        for that frame as a previous one."""
        B, _, N = imgs.shape[:3]
        flat = imgs.reshape((B * N,) + imgs.shape[3:])
        vox, _ = self._early_vox(flat, self._clip_trunk(flat), depth[:, 0],
                                 self._lift_args1(metas, B, N), metas.get("lift_sorted"))
        return vox

    def full_forward_streaming(self, imgs, depth_imgs, metas, ov_weight, prev_vox,
                               prev_lidarego2global):
        """The temporal forward with the previous frames' lifted voxels
        taken from a cache instead of recomputed: depth tower (no gradient)
        then `forward_streaming`."""
        with torch.no_grad():
            depth = self.estimate_depth(depth_imgs)
        return self.forward_streaming(imgs, depth, metas, ov_weight, prev_vox,
                                      prev_lidarego2global)

    def forward_streaming(self, imgs, depth, metas, ov_weight, prev_vox, prev_lidarego2global):
        """Single-frame imgs (B, 1, N, ...) and depth, the frame's F=1 metas
        plus lidarego2global (B, 4, 4); prev_vox (B, F-1, Zf, Yf, Xf, C)
        cached `forward_early` voxels of the previous frames, frame t-1
        first, each in its own ego frame; prev_lidarego2global
        (B, F-1, 4, 4). Equals the batched forward on the equivalent
        (B, F, N, ...) batch, and returns the current frame's `early_vox`
        for the next call's cache."""
        with torch.no_grad(), tracing.span("model.warp"):
            prevs = [self.align_to_prev(prev_vox[:, t], metas["lidarego2global"],
                                        prev_lidarego2global[:, t])
                     for t in range(prev_vox.shape[1])]
        B, _, N = imgs.shape[:3]
        flat0 = imgs.reshape((B * N,) + imgs.shape[3:])
        return self._forward_current(flat0, self._clip_trunk(flat0), depth[:, 0], ov_weight, B, N,
                                     self._lift_args1(metas, B, N), metas.get("lift_sorted"),
                                     occ_feat_prevs=prevs, return_early_vox=True)

    def _clip_trunk(self, flat):
        """CLIP trunk features of flat (B*N, H, W, 3) camera images, at half
        resolution."""
        with tracing.span("model.clip"):
            return self.clip_visual(resize_bilinear(flat, (flat.shape[1] // 2,
                                                           flat.shape[2] // 2)))

    @staticmethod
    def _lift_args1(metas, B, N):
        """The lift's geometry arguments of a single-frame batch."""
        s2k = resolve_sensor2keyegos(metas, B, 1, N)[:, 0]
        return (s2k, metas["intrins"][:, 0], metas["post_rots"][:, 0],
                metas["post_trans"][:, 0], metas["bda"])

    def align_to_prev(self, occ_feat, lidarego2global, prev_lidarego2global):
        """Ego-motion warp of a previous frame's voxels (B, Z, Y, X, C), in
        that frame's ego coordinates, to the current frame's voxel centres:
        cur2prev = prev^-1 @ cur in elementwise fp32 (no TF32 can reach it),
        trilinear, zeros outside, align_corners=True. Returns fp32, as the
        JAX op's promotion of compute-dtype features at fp32 coordinates."""
        return graphs.region("warp", self._warp, occ_feat, lidarego2global,
                             prev_lidarego2global)

    def _warp(self, occ_feat, lidarego2global, prev_lidarego2global):
        g = self.cfg.grid.scaled(self.cfg.lss_feat_ds)
        B, Z, Y, X, _ = occ_feat.shape
        dev, f32 = occ_feat.device, torch.float32

        def centres(n, ax):
            return torch.arange(n, dtype=f32, device=dev) * ax[2] + (ax[0] + ax[2] / 2)

        xs, ys, zs = centres(X, g.x), centres(Y, g.y), centres(Z, g.z)
        zz, yy, xx = torch.meshgrid(zs, ys, xs, indexing="ij")
        pts = torch.stack([xx, yy, zz], -1)  # (Z, Y, X, 3) metres
        cur2prev = compose_se3(se3_inverse(prev_lidarego2global.to(f32)),
                               lidarego2global.to(f32))  # (B, 4, 4)
        p = _matvec(cur2prev[:, None, None, None, :3, :3], pts)
        p = p + cur2prev[:, None, None, None, :3, 3]
        first = torch.stack([xs[0], ys[0], zs[0]])
        last = torch.stack([xs[-1], ys[-1], zs[-1]])
        # multiply by the fp32 reciprocal: XLA rewrites the reference's
        # division by this constant that way
        grid = (p - first) * (1.0 / (last - first)) * 2.0 - 1.0  # normalized (x, y, z)
        return grid_sample_3d(occ_feat, grid, align_corners=True, padding_mode="zeros")

    @staticmethod
    def semantic_inference_2d(mask_logits, mask_embs, mask_preds):
        """softmax classes (bg dropped) x sigmoid masks -> per-pixel class
        probs (B,h,w,P) and CLIP embeddings (B,h,w,C)."""
        cls = torch.softmax(mask_logits, -1)[..., :-1]
        m = torch.sigmoid(mask_preds)
        return (torch.einsum("bqp,bqhw->bhwp", cls, m),
                torch.einsum("bqc,bqhw->bhwc", mask_embs, m))


def _frozen(train: bool):
    """The stage-2 no-grad boundary around the frozen towers' outputs."""
    return torch.no_grad() if train else contextlib.nullcontext()


def retrieval_map(feat_occ, text_embed, eps: float = 1e-8):
    """Per-voxel cosine against a free-text prompt embedding: feat_occ
    (B, Z, Y, X, C), text_embed (C,) -> (B, X, Y, Z) fp32 scores, the
    denominator guarded by eps (a zero embedding gives an all-zero map)."""
    q = text_embed.reshape(-1).float()
    f = feat_occ.float()
    denom = torch.clamp_min(torch.linalg.vector_norm(f, dim=-1) * torch.linalg.vector_norm(q),
                            eps)
    return ((f @ q) / denom).permute(0, 3, 2, 1)


def fused_classes(out, membership):
    """The (B, X, Y, Z) int32 class grid of the model's raw outputs: the
    vocabulary's prompts merged into classes by max (`membership` from
    `nn/text.py` `merge_matrix`), then the fusion rule."""
    return fusion_rule(merge_classes_max(out["sem_occ_raw"], membership, axis=-1),
                       out["bin_occ"])


def fusion_rule(sem_occ_merged, bin_occ, free_idx: int = 17):
    """Test-time class fusion: (B, Z, Y, X, 18) merged logits and
    (B, Z, Y, X, 2) occupancy -> (B, X, Y, Z) int32 class grid."""
    cls = sem_occ_merged.argmax(-1)
    occupied = torch.softmax(bin_occ, -1)[..., 0] > 0.5
    pred = torch.where(occupied, cls, torch.full_like(cls, free_idx))
    return pred.permute(0, 3, 2, 1).to(torch.int32)
