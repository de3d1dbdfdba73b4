"""The VEON graph, F=1, for serving and for the stage-2 train step
(counterpart of `veon_tpu/model/veon.py` `VeonModel.full_forward`,
`__call__`, `_forward_current`, `_early_vox`, `semantic_inference_2d` and
`fusion_rule`).

Layout as on the JAX side: frame-major (B, F, N, ...) batches, channel-last
images and voxels, voxel outputs (B, Z, Y, X, C). Params are fp32; the
towers compute in `cfg.compute_dtype`; outputs are fp32.

The lift: a fixed rig's presorted streams when `metas` carry "lift_sorted"
(serving), else `cfg.lss_banded` picks the banded lift from metric depth
(the training default) or the reference full-frustum lift.

train=True mirrors the reference's stage-2 no-grad boundary: the depth
tower, the CLIP trunk features and the side adapter / rec-head outputs are
computed without gradient; the deep-CLIP rerun inside the lift path
(`rec_head.update_remaining`) is NOT, so HSA's gradient flows through the
frozen rec head's blocks.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch import nn

from .. import resolve_device, torch_dtype
from ..configs.base import VeonConfig
from ..geometry.frustum import sensor2keyego_chain
from ..lift.lss import LSSLift, min_pool_depth, two_hot_depth
from ..nn.alignnet import AlignNet3D, LiftFusion
from ..nn.dpt import DepthAnythingV2
from ..nn.hsa import HighresSideAdaptor
from ..nn.san import SideAdapterNetwork
from ..nn.vit import CLIPRecHead, CLIPVisualExtractor
from ..ops.resize import resize_bilinear, resize_trilinear

VOXEL_OUTPUTS = ("bin_occ", "feat_occ", "sem_occ_raw")


class VeonModel(nn.Module):
    """End-to-end VEON inference graph. Submodules carry the flax module
    names, so `ckpt/from_jax.py` maps a JAX variables tree onto them."""

    def __init__(self, cfg: VeonConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
        dt = torch_dtype(c.compute_dtype)
        with torch.device(resolve_device(device)):
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
                c.san.clip_patch_size, c.san.clip_pretrain_grid, save_layers, dtype=dt)
            self.side_adapter = SideAdapterNetwork(c.san, dtype=dt)
            self.rec_head = CLIPRecHead(
                c.san.clip_width, c.san.clip_heads, c.san.feature_last_layer_idx,
                c.san.clip_layers, c.san.clip_embed_dim, c.san.num_queries,
                c.san.rec_downsample_method, c.san.rec_cross_attn, dtype=dt)
            self.hsa = HighresSideAdaptor(c.hsa, dtype=dt)
            self.lift_fusion = LiftFusion(c.propagation, c.hsa.manip_supp_dim,
                                          c.san.clip_width, dtype=dt)
            self.alignnet = AlignNet3D(c.propagation, c.propagation.clip_proj_dim, dtype=dt)
        self.lift = LSSLift.from_config(c)

    def estimate_depth(self, depth_imgs):
        """(B, F, N, Hd, Wd, 3) DA-V2-normalized -> (B, F, N, H/2, W/2) metric,
        resized bilinear align_corners=True."""
        B, F, N = depth_imgs.shape[:3]
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

    def forward(self, imgs, depth, metas, ov_weight, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        """imgs (B, F, N, H, W, 3); depth (B, F, N, H/2, W/2) metric; metas
        with the rig (sensor2egos, ego2globals, intrins, post_rots,
        post_trans, bda) and optionally "lift_sorted" from
        `LSSLift.precompute_sorted`; ov_weight (P+1, C_embed). Returns
        sem_seg_ds / sem_embed_ds (B,N,h,w,C), clip_feat, bin_occ
        (B,Z,Y,X,2), feat_occ, sem_occ_raw (B,Z,Y,X,P+1)."""
        B, F, N = imgs.shape[:3]
        if F != 1:
            raise NotImplementedError("F>1 temporal frames are not ported yet")
        flat = imgs.reshape((-1,) + imgs.shape[3:])
        clip_input = resize_bilinear(flat, (flat.shape[1] // 2, flat.shape[2] // 2))
        with _frozen(train):
            feats = self.clip_visual(clip_input)
        s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(B, F * N, 4, 4),
                                  metas["ego2globals"].reshape(B, F * N, 4, 4), F, N)
        lift_args = (s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0],
                     metas["post_trans"][:, 0], metas["bda"])
        return self._forward_current(flat, feats, depth[:, 0], ov_weight, B, N, lift_args,
                                     metas.get("lift_sorted"), train)

    def _forward_current(self, flat0, feats, depth0, ov_weight, B, N, lift_args, presorted,
                         train: bool = False):
        c = self.cfg
        with _frozen(train):
            mask_preds, attn_bias, _ = self.side_adapter(flat0, feats)
            mask_embs = self.rec_head(feats, attn_bias, normalize=True)
        vox, feats_0 = self._early_vox(flat0, feats, depth0, lift_args, presorted)
        occ = self.alignnet(vox, train=train)
        nx, ny, nz = c.grid.size
        feat_occ = resize_trilinear(occ["feat_occ"], (nz, ny, nx))
        bin_occ = resize_trilinear(occ["bin_occ"], (nz, ny, nx))
        sem_occ_raw = feat_occ @ ov_weight.to(feat_occ.dtype).T
        mask_logits = mask_embs @ ov_weight.to(mask_embs.dtype).T
        sem_seg_ds, sem_embed_ds = self.semantic_inference_2d(mask_logits, mask_embs, mask_preds)
        proj = feats_0["clip_feat_proj"]
        out = {
            "sem_seg_ds": sem_seg_ds.reshape((B, N) + sem_seg_ds.shape[1:]),
            "sem_embed_ds": sem_embed_ds.reshape((B, N) + sem_embed_ds.shape[1:]),
            "clip_feat": proj.reshape((B, N) + proj.shape[1:]),
            "bin_occ": bin_occ, "feat_occ": feat_occ, "sem_occ_raw": sem_occ_raw,
        }
        return {k: v.float() for k, v in out.items()}

    def _early_vox(self, flat_imgs, feats, depth_f, lift_args, presorted=None):
        """HSA + deep-CLIP rerun + fuse + LSS lift for one frame.
        flat_imgs (B*N, H, W, 3); depth_f (B, N, H/2, W/2)."""
        c = self.cfg
        B, N = depth_f.shape[:2]
        attns, supp = self.hsa(flat_imgs, feats)
        feats = self.rec_head.update_remaining(feats, attns)
        lift_hw = (c.data.input_size[0] // c.lss_downsample,
                   c.data.input_size[1] // c.lss_downsample)
        fused = self.lift_fusion(supp, feats[str(c.san.clip_layers)], lift_hw)
        fused = fused.reshape((B, N) + fused.shape[1:])
        d_ds = min_pool_depth(depth_f, 8)
        if presorted is not None:
            vox = self.lift.lift_presorted(fused, two_hot_depth(d_ds, c.grid), presorted)
        elif c.lss_banded:
            vox = self.lift.lift_from_metric(fused, d_ds, *lift_args)
        else:
            vox = self.lift(fused, two_hot_depth(d_ds, c.grid), *lift_args)
        return vox, feats

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


def fusion_rule(sem_occ_merged, bin_occ, free_idx: int = 17):
    """Test-time class fusion: (B, Z, Y, X, 18) merged logits and
    (B, Z, Y, X, 2) occupancy -> (B, X, Y, Z) int32 class grid."""
    cls = sem_occ_merged.argmax(-1)
    occupied = torch.softmax(bin_occ, -1)[..., 0] > 0.5
    pred = torch.where(occupied, cls, torch.full_like(cls, free_idx))
    return pred.permute(0, 3, 2, 1).to(torch.int32)
