"""Training losses (counterpart of `veon_tpu/train/losses.py`): the
stage-2 occupancy loss (class-weighted binary-occupancy CE plus the 2D->3D
distillation of the per-pixel CLIP semantics into the voxel embeddings,
vectorised as masked reductions with static shapes), the stage-1 depth
losses (SILog plus the two-hot bin CE), and the reference's available but
unused terms: the scene-completion affinity losses, the 2D pixel alignment
and the velocity L1."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import GridConfig, LossConfig
from ..geometry.frustum import compose_se3, se3_inverse
from ..lift.lss import depth_bins_one_hot_gt, one_hot_depth, two_hot_depth
from ..nn.text import merge_classes_max
from ..ops.grid_sample import grid_sample_2d

# nuScenes-Occ3D voxel counts per class (public dataset statistics), for
# the balanced CE weights
NUSC_CLASS_FREQUENCIES = np.array([
    944004, 1897170, 152386, 2391677, 16957802, 724139, 189027, 2074468,
    413451, 2384460, 5916653, 175883646, 4275424, 51393615, 61411620,
    105975596, 116424404, 1892500630,
], dtype=np.float64)


def _weighted_ce(logits, target, weights, valid):
    """torch CrossEntropyLoss with class weights over `valid` voxels:
    sum(w_t * nll_t) / sum(w_t), in fp32."""
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, target[..., None])[..., 0]
    wt = weights[target] * valid
    return (nll * wt).sum() / torch.clamp_min(wt.sum(), 1e-6)


def bce_bin_occ_loss(bin_occ, voxel_semantics, class_weights: Sequence[float] = (1.0, 0.5),
                     free_idx: int = 17, ignore_idx: int = 255):
    """bin_occ (B, X, Y, Z, 2) logits, voxel_semantics (B, X, Y, Z) int
    (255 = ignore): class 1 = free, class 0 = occupied."""
    target = (voxel_semantics == free_idx).long()
    w = torch.tensor(class_weights, dtype=torch.float32, device=bin_occ.device)
    return _weighted_ce(bin_occ, target, w, voxel_semantics != ignore_idx)


def balanced_class_weights(out_channel: int = 18) -> np.ndarray:
    """1/log(freq + 1e-3) class weights."""
    return (1.0 / np.log(NUSC_CLASS_FREQUENCIES[:out_channel] + 0.001)).astype(np.float32)


def ce_sem_occ_loss(sem_occ, voxel_semantics, class_weights: Optional[Sequence[float]] = None,
                    ignore_idx: int = 255):
    """Full semantic-occupancy CE over C classes, balanced weights by
    default. sem_occ (B, X, Y, Z, C) logits; voxel_semantics (B, X, Y, Z)."""
    C = sem_occ.shape[-1]
    if class_weights is None:
        class_weights = balanced_class_weights(C)
    w = torch.as_tensor(np.asarray(class_weights, np.float32), device=sem_occ.device)
    tgt = voxel_semantics.clamp(0, C - 1).long()
    return _weighted_ce(sem_occ, tgt, w, voxel_semantics != ignore_idx)


def pixel_align_2d_loss(sem_seg_ds, clip_feat, ov_weight):
    """2D pixel-alignment cosine loss (unused by the shipping config): the
    CLIP-projected map pulled toward the text embedding of each pixel's
    argmax class. sem_seg_ds (B, N, H, W, P) class scores; clip_feat
    (B, N, h, w, D), nearest-resized to (H, W); ov_weight (P+1, D), the
    background row dropped. Returns 1 - mean cosine."""
    pseudo = ov_weight[:-1].to(clip_feat.dtype)[sem_seg_ds.argmax(-1)]
    H, W = sem_seg_ds.shape[2:4]
    h, w = clip_feat.shape[2:4]
    if (h, w) != (H, W):
        dev = clip_feat.device
        iy = (torch.arange(H, device=dev) * h) // H
        ix = (torch.arange(W, device=dev) * w) // W
        clip_feat = clip_feat[:, :, iy][:, :, :, ix]
    return 1.0 - _cosine(pseudo, clip_feat).mean()


def vel_loss(pred, gt):
    """L1 velocity loss."""
    return (pred.float() - gt.float()).abs().mean()


def _cosine(a, b, eps=1e-6):
    num = (a * b).sum(-1)
    return num / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1)
                                 * torch.linalg.vector_norm(b, dim=-1), eps)


def voxel_centers(grid: GridConfig) -> np.ndarray:
    """(X, Y, Z, 3) voxel-center xyz in ego meters."""
    nx, ny, nz = grid.size
    out = np.empty((nx, ny, nz, 3), dtype=np.float32)
    out[..., 0] = (np.arange(nx) * grid.x[2] + grid.x[0] + grid.x[2] / 2)[:, None, None]
    out[..., 1] = (np.arange(ny) * grid.y[2] + grid.y[0] + grid.y[2] / 2)[None, :, None]
    out[..., 2] = (np.arange(nz) * grid.z[2] + grid.z[0] + grid.z[2] / 2)[None, None, :]
    return out


def _affine(m, pts):
    """(B, N, 3, 4) affine maps applied to (V, 3) points -> (B, N, V, 3),
    elementwise fp32 (no TF32)."""
    rows = [((m[:, :, None, i, 0] * pts[:, 0] + m[:, :, None, i, 1] * pts[:, 1])
             + m[:, :, None, i, 2] * pts[:, 2]) + m[:, :, None, i, 3] for i in range(3)]
    return torch.stack(rows, -1)


def proj_2d_to_3d_loss(pred_feat_occ, sem_seg_2d, voxel_semantics, cam_metas, ov_weight,
                       membership: np.ndarray, priority: Sequence[int], grid: GridConfig,
                       image_hw: Tuple[int, int], epoch, cfg: LossConfig):
    """The 2D->3D distillation loss. pred_feat_occ (B, X, Y, Z, C);
    sem_seg_2d (B, N, h, w, P) per-pixel prompt scores; voxel_semantics
    (B, X, Y, Z) (255 ignore, 17 free); cam_metas: intrins / post_rots
    (B, N, 3, 3), post_trans (B, N, 3), cam2camego / camego2global
    (B, N, 4, 4), lidarego2global (B, 4, 4); ov_weight (P+1, C);
    membership (G+1, P+1) prompt groups; epoch >= cfg.stage2_start turns on
    the priority-concerned ignorance. Returns (loss_det, loss_soft)."""
    B, X, Y, Z, C = pred_feat_occ.shape
    N, P = sem_seg_2d.shape[1], sem_seg_2d.shape[-1]
    V = X * Y * Z
    dev = pred_feat_occ.device
    class_num = cfg.out_channel - 1
    prio = torch.tensor(priority, dtype=torch.float32, device=dev)
    member = torch.as_tensor(membership[:class_num, :P], device=dev)
    group_of_prompt = torch.as_tensor(np.argmax(membership[:class_num, :P], axis=0), device=dev)

    centers = torch.from_numpy(voxel_centers(grid)).to(dev).reshape(V, 3)
    feat = pred_feat_occ.reshape(B, V, C)
    gt = voxel_semantics.reshape(B, V).long()
    sem_valid = (gt < class_num) & (gt >= 0)
    gt_c = gt.clamp(0, class_num - 1)

    # voxel centers -> every camera's image: lidarego -> cam -> image
    cam2global = compose_se3(cam_metas["camego2global"].float(), cam_metas["cam2camego"].float())
    lidarego2cam = compose_se3(se3_inverse(cam2global),
                               cam_metas["lidarego2global"].float()[:, None])
    cam2img = torch.zeros(B, N, 4, 4, device=dev)
    cam2img[:, :, 3, 3] = 1.0
    cam2img[:, :, :3, :3] = cam_metas["intrins"].float()
    pts = _affine(compose_se3(cam2img, lidarego2cam)[:, :, :3], centers)  # (B, N, V, 3)
    depth = pts[..., 2]
    uv = pts[..., :2] / torch.where(depth.abs() > 1e-6, depth, torch.full_like(depth, 1e-6))[..., None]
    uvd = torch.cat([uv, depth[..., None]], -1)
    post_rots = cam_metas["post_rots"].float()
    uvd = torch.stack([(post_rots[:, :, None, i, 0] * uvd[..., 0]
                        + post_rots[:, :, None, i, 1] * uvd[..., 1])
                       + post_rots[:, :, None, i, 2] * uvd[..., 2] for i in range(3)], -1)
    uvd = uvd + cam_metas["post_trans"].float()[:, :, None, :]

    Himg, Wimg = image_hw
    u, v, d = uvd[..., 0], uvd[..., 1], uvd[..., 2]
    in_img = (u >= 0) & (u <= Wimg - 1) & (v >= 0) & (v <= Himg - 1)
    in_depth = (d >= grid.depth[0]) & (d < grid.depth[1])
    valid = in_img & in_depth & sem_valid[:, None, :]  # (B, N, V)

    # bilinear sample of the semantic map at the image coords (align_corners=False)
    coords = torch.stack([u / ((Wimg - 1) / 2.0) - 1.0, v / ((Himg - 1) / 2.0) - 1.0], -1)
    maps = sem_seg_2d.reshape((B * N,) + sem_seg_2d.shape[2:])
    sampled = grid_sample_2d(maps, coords.reshape(B * N, V, 2)).reshape(B, N, V, P)

    # per-group restricted argmax and merged (group-max) argmax
    neg = torch.finfo(sampled.dtype).min
    masked = torch.where(member[gt_c][:, None], sampled, torch.full_like(sampled, neg))
    restricted_idx = masked.argmax(-1)  # (B, N, V) prompt ids
    merged_idx = merge_classes_max(sampled, membership[:class_num, :P], axis=-1).argmax(-1)
    raw_idx = sampled.argmax(-1)

    gt_bnv = gt_c[:, None].expand(merged_idx.shape)
    sel_soft = (merged_idx == gt_bnv) | (gt_bnv >= class_num - cfg.ov_class_number)
    sel_det = ~sel_soft

    # cosine(ovw[idx], feat) from one (B, V, P+1) dot table
    ovw = ov_weight.to(feat.dtype)
    dots = feat @ ovw.T
    feat_norm = torch.linalg.vector_norm(feat, dim=-1)  # (B, V)
    ovw_norm = torch.linalg.vector_norm(ovw, dim=-1)  # (P+1,)

    def cos_with_prompt(idx_bnv):
        sel = dots.gather(2, idx_bnv.transpose(1, 2)).transpose(1, 2)
        return sel / torch.clamp_min(feat_norm[:, None] * ovw_norm[idx_bnv], 1e-6)

    # priority-concerned ignorance (epoch >= stage2_start)
    dots_sg = dots.detach()
    pred_prompt = dots_sg[..., :-1].argmax(-1)  # (B, V)
    cos_conf = dots_sg.gather(-1, pred_prompt[..., None])[..., 0]
    cos_conf = cos_conf / torch.clamp_min(feat_norm.detach() * ovw_norm[pred_prompt], 1e-6)
    pred_prio = prio[group_of_prompt[pred_prompt]]
    lifted_prio = prio[merged_idx.clamp(0, class_num - 1)]  # (B, N, V)
    high_conf = (cos_conf[:, None] >= cfg.high_conf_thr) & (pred_prio[:, None] > lifted_prio)
    ignore_on = bool(int(epoch) >= cfg.stage2_start)
    if ignore_on:
        sel_soft = sel_soft & ~high_conf

    def weighted_loss(sel, cls_idx, target_prompt_idx, extra_weight):
        """Class-balanced cosine loss per camera, (B,)."""
        m = (sel & valid).to(feat.dtype)  # (B, N, V)
        loss_each = (1.0 - cos_with_prompt(target_prompt_idx)) * m
        onehot = F.one_hot(cls_idx, class_num).to(feat.dtype) * m[..., None]
        counts = onehot.sum(2)  # (B, N, 17)
        exist = counts > 0
        inv = torch.where(exist, 1.0 / torch.clamp_min(counts, 1.0), torch.zeros_like(counts))
        if extra_weight is not None:
            inv = inv * extra_weight[None, None, :]
        inst_w = torch.einsum("bnvk,bnk->bnv", onehot, inv)
        denom = torch.where(exist, prio[None, None, :], torch.zeros_like(counts)).sum(-1)
        loss_cam = (loss_each * inst_w).sum(-1) / torch.clamp_min(denom, 1e-6)
        num_cam = m.sum(-1)  # (B, N)
        tot = torch.clamp_min(num_cam.sum(-1, keepdim=True), 1.0)
        has_any = (num_cam > 0).to(feat.dtype)
        return (loss_cam * has_any * num_cam / tot).sum(-1)

    del_weight = 0.0 if class_num == cfg.ov_class_number else 1.0
    loss_det = weighted_loss(sel_det, gt_bnv, restricted_idx, None) * del_weight
    loss_soft = weighted_loss(sel_soft, merged_idx.clamp(0, class_num - 1), raw_idx, prio)
    return loss_det.mean(), loss_soft.mean()


def occupancy_loss(outputs: Dict[str, torch.Tensor], voxel_semantics, mask_camera, cam_metas,
                   ov_weight, membership: np.ndarray, grid: GridConfig,
                   image_hw: Tuple[int, int], epoch, cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Stage-2 loss dict: invisible voxels (mask_camera == 0) become ignore,
    then the weighted BCE bin loss and the weighted distillation losses.
    outputs carry bin_occ / feat_occ (B, Z, Y, X, C) and sem_seg_ds;
    voxel_semantics / mask_camera (B, X, Y, Z); cam_metas may hold the
    model's (B, F, N, ...) metas, of which frame 0 is used."""
    vs = torch.where(mask_camera == 0, torch.full_like(voxel_semantics, cfg.ignore_idx),
                     voxel_semantics)
    bin_occ = outputs["bin_occ"].permute(0, 3, 2, 1, 4)
    feat_occ = outputs["feat_occ"].permute(0, 3, 2, 1, 4)
    cam_metas = dict(cam_metas)
    for k in ("intrins", "post_rots"):
        if cam_metas[k].dim() == 5:
            cam_metas[k] = cam_metas[k][:, 0]
    if cam_metas["post_trans"].dim() == 4:
        cam_metas["post_trans"] = cam_metas["post_trans"][:, 0]
    losses = {"loss_binocc": cfg.loss_voxel_ce_weight * bce_bin_occ_loss(
        bin_occ, vs, cfg.bin_class_weights, cfg.empty_idx, cfg.ignore_idx)}
    loss_det, loss_soft = proj_2d_to_3d_loss(
        feat_occ, outputs["sem_seg_ds"], vs, cam_metas, ov_weight, membership, cfg.priority,
        grid, image_hw, epoch, cfg)
    if cfg.ov_class_number != cfg.out_channel - 1:
        losses["loss_featalign_det"] = loss_det * cfg.loss_featalign_det_weight
    if cfg.ov_class_number != 0:
        losses["loss_featalign_soft"] = loss_soft * cfg.loss_featalign_soft_weight
    return losses


# auxiliary scene-completion losses (available, unused by the shipping config)


def geo_scal_loss(pred_logits, target, free_idx: int = 17, ignore_idx: int = 255):
    """Geometric scene-completion affinity loss: precision, recall and
    specificity BCE on the non-free probability. pred_logits
    (B, X, Y, Z, C); target (B, X, Y, Z) ints."""
    empty = torch.softmax(pred_logits.float(), -1)[..., free_idx]
    nonempty = 1.0 - empty
    mask = (target != ignore_idx).float()
    gt_nonempty = ((target != free_idx) & (target != ignore_idx)).float()
    eps = 1e-6
    inter = (nonempty * gt_nonempty * mask).sum()
    precision = inter / torch.clamp_min((nonempty * mask).sum(), eps)
    recall = inter / torch.clamp_min(gt_nonempty.sum(), eps)
    spec = (empty * (1 - gt_nonempty) * mask).sum() / torch.clamp_min(
        ((1 - gt_nonempty) * mask).sum(), eps)
    return (-torch.log(torch.clamp(precision, eps, 1.0)) - torch.log(torch.clamp(recall, eps, 1.0))
            - torch.log(torch.clamp(spec, eps, 1.0)))


def sem_scal_loss(pred_logits, target, ignore_idx: int = 255):
    """Semantic scene-completion affinity loss: per-class precision and
    recall BCE, averaged over the classes present."""
    probs = torch.softmax(pred_logits.float(), -1)
    mask = (target != ignore_idx).float()
    eps = 1e-6
    total, count = 0.0, 0.0
    for c in range(pred_logits.shape[-1]):
        p = probs[..., c] * mask
        gt_c = (target == c).float() * mask
        present = (gt_c.sum() > 0).float()
        inter = (p * gt_c).sum()
        precision = inter / torch.clamp_min(p.sum(), eps)
        recall = inter / torch.clamp_min(gt_c.sum(), eps)
        loss_c = -torch.log(torch.clamp(precision, eps, 1.0)) - torch.log(
            torch.clamp(recall, eps, 1.0))
        total = total + loss_c * present
        count = count + present
    return total / torch.clamp_min(count, 1.0)


# stage-1 depth losses


def silog_loss(pred, gt, invalid_above: float = 9225.0):
    """ZoeDepth SILog over the valid pixels (gt < 9225):
    sqrt(var(g) + 0.15 mean(g)^2) clipped at 2, g the log ratio."""
    valid = (gt < invalid_above).float()
    n = torch.clamp_min(valid.sum(), 1.0)
    alpha = 1e-7
    g = (torch.log(pred + alpha) - torch.log(gt + alpha)) * valid
    mean = g.sum() / n
    var = ((g - mean).square() * valid).sum() / n
    dg = var + 0.15 * mean.square()
    return torch.clamp(torch.sqrt(torch.clamp_min(dg, 1e-12)), max=2.0)


def _masked_bce(p, t, fg):
    """Summed BCE per row of bin probabilities p against targets t, mean
    over the rows with fg = 1 (p clipped at 1e-12 and 1 - 1e-12)."""
    eps = 1e-12
    p32 = torch.clamp(p.float(), eps, 1 - eps)
    bce = -(t * torch.log(p32) + (1 - t) * torch.log1p(-p32))
    return (bce.sum(-1) * fg).sum() / torch.clamp_min(fg.sum(), 1.0)


def depth_bin_ce_loss(pred_depth, gt_depth, grid: GridConfig):
    """Binary CE between the two-hot bins of the predicted depth and the
    one-hot bins of the GT, over the pixels whose GT is in range
    (unweighted mean)."""
    D = grid.num_depth_bins
    p = two_hot_depth(pred_depth, grid).movedim(-3, -1).reshape(-1, D)
    t = one_hot_depth(gt_depth, grid).movedim(-3, -1).reshape(-1, D)
    return _masked_bce(p, t, (t.amax(-1) > 0.0).float())


def depth_bce_loss(pred_bins, gt_depth, grid: GridConfig, downsample: int,
                   weight: float = 0.05):
    """The legacy bin-BCE depth loss: predicted bin probabilities
    (..., D, h, w) against the downsampled one-hot GT, summed BCE over the
    foreground pixels, times `weight`."""
    D = grid.num_depth_bins
    labels = depth_bins_one_hot_gt(gt_depth, grid, downsample).reshape(-1, D)
    p = pred_bins.movedim(-3, -1).reshape(-1, D)
    return weight * _masked_bce(p, labels, (labels.amax(-1) > 0.0).float())


def depth_pretrain_loss(pred_depth, gt_depth, grid: GridConfig, cfg: LossConfig
                        ) -> Dict[str, torch.Tensor]:
    """The stage-1 loss dict: SILog and the weighted bin CE."""
    return {"loss_depth_zoe": silog_loss(pred_depth, gt_depth),
            "loss_depth_ce": cfg.loss_depth_ce_weight * depth_bin_ce_loss(pred_depth, gt_depth,
                                                                          grid)}
