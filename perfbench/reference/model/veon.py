"""The VEON streaming serving graph (counterpart of `veon_tpu/model/veon.py`
`VeonModel._forward_current`, `_early_vox`, `forward_early`,
`forward_streaming`, `full_forward_streaming`, `align_to_prev`,
`semantic_inference_2d` and `fusion_rule`): one frame of a fixed rig
through its presorted lift, fused with the cached voxels of the frames
before (`serve/streaming.py` keeps them) after the ego-motion warp.

Layout as on the JAX side: (B, 1, N, ...) frames, channel-last images and
voxels, voxel outputs (B, Z, Y, X, C). Params are fp32; the towers
compute in `cfg.compute_dtype`; outputs are fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device, torch_dtype
from ..configs.base import VeonConfig
from ..geometry.frustum import _matvec, compose_se3, se3_inverse
from ..lift.lss import LSSLift, min_pool_depth, two_hot_depth
from ..nn.alignnet import AlignNet3D, LiftFusion
from ..nn.dpt import DepthAnythingV2
from ..nn.hsa import HighresSideAdaptor
from ..nn.san import SideAdapterNetwork
from ..nn.text import merge_classes_max
from ..nn.vit import CLIPRecHead, CLIPVisualExtractor
from ..nn.zoedepth import ZoeDepthNK
from ..ops.grid_sample import grid_sample_3d
from ..ops.resize import resize_bilinear, resize_trilinear

class VeonModel(nn.Module):
    """End-to-end VEON inference graph. Submodules carry the flax module
    names, so `ckpt/from_jax.py` maps a JAX variables tree onto them."""

    def __init__(self, cfg: VeonConfig, device="cuda"):
        super().__init__()
        c = self.cfg = cfg
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
                c.san.clip_patch_size, c.san.clip_pretrain_grid, save_layers, dtype=dt)
            self.side_adapter = SideAdapterNetwork(c.san, dtype=dt)
            self.rec_head = CLIPRecHead(
                c.san.clip_width, c.san.clip_heads, c.san.feature_last_layer_idx,
                c.san.clip_layers, c.san.clip_embed_dim, c.san.num_queries,
                c.san.rec_downsample_method, c.san.rec_cross_attn, dtype=dt)
            self.hsa = HighresSideAdaptor(c.hsa, dtype=dt)
            self.lift_fusion = LiftFusion(c.propagation, c.hsa.manip_supp_dim,
                                          c.san.clip_width, dtype=dt)
            self.alignnet = AlignNet3D(c.propagation, c.propagation.clip_proj_dim,
                                       c.num_temporal, dtype=dt)
        self.lift = LSSLift.from_config(c)

    def estimate_depth(self, depth_imgs):
        """(B, F, N, Hd, Wd, 3) DA-V2- or midas-normalized (the depth
        branch's) -> (B, F, N, H/2, W/2) metric, resized bilinear
        align_corners=True."""
        B, F, N = depth_imgs.shape[:3]
        d = self.depth(depth_imgs.reshape((-1,) + depth_imgs.shape[3:]))
        h2, w2 = self.cfg.data.input_size[0] // 2, self.cfg.data.input_size[1] // 2
        if tuple(d.shape[-2:]) != (h2, w2):
            d = resize_bilinear(d[..., None], (h2, w2), align_corners=True)[..., 0]
        return d.reshape((B, F, N) + d.shape[1:])

    def _forward_current(self, flat0, feats, depth0, ov_weight, B, N, presorted, occ_feat_prevs):
        """The current frame's decode, lift and 3D head; occ_feat_prevs are
        the previous frames' voxels already warped into this frame's ego.
        Returns the outputs and the frame's voxels (`early_vox`, in the
        compute dtype: the next call's cached previous frame)."""
        mask_preds, attn_bias, _ = self.side_adapter(flat0, feats)
        mask_embs = self.rec_head(feats, attn_bias, normalize=True)
        vox, feats_0 = self._early_vox(flat0, feats, depth0, presorted)
        bin_occ, feat_occ, sem_occ_raw = self.voxel_head(vox, occ_feat_prevs, ov_weight)
        mask_logits = mask_embs @ ov_weight.to(mask_embs.dtype).T
        sem_seg_ds, sem_embed_ds = self.semantic_inference_2d(mask_logits, mask_embs, mask_preds)
        proj = feats_0["clip_feat_proj"]
        out = {
            "sem_seg_ds": sem_seg_ds.reshape((B, N) + sem_seg_ds.shape[1:]),
            "sem_embed_ds": sem_embed_ds.reshape((B, N) + sem_embed_ds.shape[1:]),
            "clip_feat": proj.reshape((B, N) + proj.shape[1:]),
            "bin_occ": bin_occ, "feat_occ": feat_occ, "sem_occ_raw": sem_occ_raw,
        }
        out = {k: v.float() for k, v in out.items()}
        out["early_vox"] = vox.detach()
        return out

    def voxel_head(self, vox, occ_feat_prevs, ov_weight):
        """The 3D head on a frame's lifted voxels and the previous frames'
        voxels already warped into its ego: temporal fusion, ResBlocks, the
        occupancy and embedding heads resized to the full grid, and the
        open-vocabulary product -> (bin_occ, feat_occ, sem_occ_raw)."""
        occ = self.alignnet(vox, list(occ_feat_prevs))
        nx, ny, nz = self.cfg.grid.size
        feat_occ = resize_trilinear(occ["feat_occ"], (nz, ny, nx))
        bin_occ = resize_trilinear(occ["bin_occ"], (nz, ny, nx))
        return bin_occ, feat_occ, feat_occ @ ov_weight.to(feat_occ.dtype).T

    def _early_vox(self, flat_imgs, feats, depth_f, presorted):
        """HSA + deep-CLIP rerun + fuse + the presorted LSS lift for one
        frame. flat_imgs (B*N, H, W, 3); depth_f (B, N, H/2, W/2)."""
        c = self.cfg
        B, N = depth_f.shape[:2]
        attns, supp = self.hsa(flat_imgs, feats)
        feats = self.rec_head.update_remaining(feats, attns)
        lift_hw = (c.data.input_size[0] // c.lss_downsample,
                   c.data.input_size[1] // c.lss_downsample)
        fused = self.lift_fusion(supp, feats[str(c.san.clip_layers)], lift_hw)
        fused = fused.reshape((B, N) + fused.shape[1:])
        d_ds = min_pool_depth(depth_f, 8)
        vox = self.lift.lift_presorted(fused, two_hot_depth(d_ds, c.grid), presorted)
        return vox, feats

    def forward_early(self, imgs, depth, metas):
        """One frame's early pipeline for the streaming cache (CLIP trunk,
        HSA, deep-CLIP rerun, fuse, lift) in its own ego frame: imgs
        (B, 1, N, H, W, 3), depth (B, 1, N, H/2, W/2), the frame's own F=1
        metas with "lift_sorted" -> vox (B, Zf, Yf, Xf, C)."""
        B, _, N = imgs.shape[:3]
        flat = imgs.reshape((B * N,) + imgs.shape[3:])
        vox, _ = self._early_vox(flat, self._clip_trunk(flat), depth[:, 0], metas["lift_sorted"])
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
        with "lift_sorted" plus lidarego2global (B, 4, 4); prev_vox
        (B, F-1, Zf, Yf, Xf, C) cached `forward_early` voxels of the
        previous frames, frame t-1 first, each in its own ego frame;
        prev_lidarego2global (B, F-1, 4, 4). Returns the current frame's
        `early_vox` for the next call's cache with the outputs."""
        with torch.no_grad():
            prevs = [self.align_to_prev(prev_vox[:, t], metas["lidarego2global"],
                                        prev_lidarego2global[:, t])
                     for t in range(prev_vox.shape[1])]
        B, _, N = imgs.shape[:3]
        flat0 = imgs.reshape((B * N,) + imgs.shape[3:])
        return self._forward_current(flat0, self._clip_trunk(flat0), depth[:, 0], ov_weight, B, N,
                                     metas["lift_sorted"], prevs)

    def _clip_trunk(self, flat):
        """CLIP trunk features of flat (B*N, H, W, 3) camera images, at half
        resolution."""
        return self.clip_visual(resize_bilinear(flat, (flat.shape[1] // 2, flat.shape[2] // 2)))

    def align_to_prev(self, occ_feat, lidarego2global, prev_lidarego2global):
        """Ego-motion warp of a previous frame's voxels (B, Z, Y, X, C), in
        that frame's ego coordinates, to the current frame's voxel centres:
        cur2prev = prev^-1 @ cur in elementwise fp32 (no TF32 can reach it),
        trilinear, zeros outside, align_corners=True. Returns fp32, as the
        JAX op's promotion of compute-dtype features at fp32 coordinates."""
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
