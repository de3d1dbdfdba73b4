"""nuScenes Occ3D and POP-3D retrieval datasets (counterpart of
`veon_tpu/data/nuscenes.py`): one plain class per dataset producing
channel-last numpy sample dicts, with the adjacent temporal frames, the
image-augmentation homographies, LiDAR depth GT, occ GT and the depth
cache handled inline. Samples are bit-equal to the reference package's:
the same per-sample generator, the same PIL resizes in the same order,
normalization last.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import DataConfig, GridConfig
from ..eval.miou import MIoUMetric
from . import transforms as T
from .native import open_image_native
from .depth_gt import (lidar2img_matrices, points_to_multiview_depth,
                       points_to_voxel_indices)


def load_infos(path: str) -> List[Dict[str, Any]]:
    """Load a bevdetv2-style infos pkl ({"infos": [...], "metadata": ...})
    sorted by timestamp (`nuscenes_dataset.py:198-212`)."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data
    return list(sorted(infos, key=lambda e: e["timestamp"]))


def _load_cached_depth(base: str) -> np.ndarray:
    """Read one cached depth map: our `.npy` files or the reference's
    torch.save `.tensor` files (`veon_depth_cache.py:149-158`) — drop-in
    interop with a cache produced by the reference's cache-depth stage."""
    if os.path.exists(base + ".npy"):
        return np.load(base + ".npy")
    t = torch.load(base + ".tensor", map_location="cpu", weights_only=True)
    return np.asarray(t.float().numpy(), np.float32)


def _load_points(path: str) -> np.ndarray:
    """nuScenes LiDAR .bin: float32 (x, y, z, intensity, ring) rows."""
    pts = np.fromfile(path, dtype=np.float32)
    return pts.reshape(-1, 5)[:, :3]


class NuScenesOccDataset:
    """Occ3D-nuScenes occupancy dataset (NuScenesDatasetOccpancy,
    `nuscenes_dataset_occ.py:38-86`, with the bevdet4d adjacent-frame
    protocol of `nuscenes_dataset.py:214-295`).

    Samples (all numpy, channel-last):
      token: str
      imgs:        (F, N, H, W, 3)  clipsan-normalized, frame 0 = current
      depth_imgs:  (F, N, dh, dw, 3) DA-V2 (or midas) normalized
        — with raw_uint8=True both are post-aug uint8 RGB instead and the
        consumer normalizes them on the device (bit-exact)
        — or depth_preds (F, N, h/2, w/2) when a depth cache is wired
      metas: sensor2egos/ego2globals (F, N, 4, 4), intrins (F, N, 3, 3),
        post_rots (F, N, 3, 3), post_trans (F, N, 3), bda (3, 3),
        lidarego2global (4, 4), prev_lidarego2global (max(F-1,1), 4, 4),
        cam2camego/camego2global (N, 4, 4)
      voxel_semantics / mask_lidar / mask_camera: (X, Y, Z)
      gt_depth: (N, H, W) sparse LiDAR min-depth (when load_lidar_depth)
    """

    def __init__(
        self,
        infos: Sequence[Dict[str, Any]],
        data_cfg: DataConfig,
        grid: GridConfig,
        num_temporal: int = 1,
        is_train: bool = False,
        data_root: Optional[str] = None,
        depth_cache_dir: Optional[str] = None,
        load_lidar_depth: bool = True,
        load_occ_gt: bool = True,
        seed: int = 0,
        raw_uint8: Optional[bool] = None,
    ):
        self.infos = list(infos)
        self.data_cfg = data_cfg
        self.grid = grid
        self.num_temporal = int(num_temporal)
        self.is_train = bool(is_train)
        self.data_root = data_root
        self.depth_cache_dir = depth_cache_dir
        self.load_lidar_depth = bool(load_lidar_depth)
        self.load_occ_gt = bool(load_occ_gt)
        self._seed = int(seed)
        # raw_uint8: post-aug uint8 images, normalized by the consumer on
        # the device (`data/transforms.py` `normalize_in_graph`). PIL
        # resamples uint8 and normalization is the last host step, so this
        # is bit-exact against the normalized float samples at a quarter of
        # their size. No effect on depth_preds (the cache holds metric depth).
        self.raw_uint8 = bool(data_cfg.raw_uint8 if raw_uint8 is None else raw_uint8)

    def __len__(self) -> int:
        return len(self.infos)

    # -- path / geometry helpers -------------------------------------------

    def _path(self, p: str) -> str:
        if os.path.isabs(p) or self.data_root is None or os.path.exists(p):
            return p
        return os.path.join(self.data_root, p)

    def _adjacent(self, index: int) -> List[Dict[str, Any]]:
        """Previous frames in the same scene; fallback to the current info at
        scene boundaries (get_adj_info, `nuscenes_dataset.py:281-295`)."""
        info = self.infos[index]
        out = []
        for gap in range(1, self.num_temporal):
            j = max(index - gap, 0)
            if self.infos[j]["scene_token"] != info["scene_token"]:
                out.append(info)
            else:
                out.append(self.infos[j])
        return out

    @staticmethod
    def _cam_se3(cam_info: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
        s2e = T.se3(cam_info["sensor2ego_rotation"], cam_info["sensor2ego_translation"])
        e2g = T.se3(cam_info["ego2global_rotation"], cam_info["ego2global_translation"])
        return s2e, e2g

    @staticmethod
    def _lidarego2global(info: Dict[str, Any]) -> np.ndarray:
        return T.se3(info["ego2global_rotation"], info["ego2global_translation"])

    # -- sample assembly ----------------------------------------------------

    def __getitem__(self, index: int) -> Dict[str, Any]:
        from PIL import Image

        cfg = self.data_cfg
        info = self.infos[index]
        frames = [info] + self._adjacent(index)
        F, N = len(frames), len(cfg.cams)
        H, W = cfg.input_size
        dH, dW = cfg.depth_input_size
        use_cache = self.depth_cache_dir is not None
        if not use_cache:
            fdh, fdw = T.dav2_size(dH, dW, target=cfg.dav2_target) \
                if cfg.depth_norm_method == "depthanythingv2" else (dH, dW)
        norm_depth = T.NORMALIZERS[cfg.depth_norm_method]

        img_dt = np.uint8 if self.raw_uint8 else np.float32
        imgs = np.empty((F, N, H, W, 3), img_dt)
        depth_imgs = None if use_cache else np.empty((F, N, fdh, fdw, 3), img_dt)
        depth_preds = np.empty((F, N, dH, dW), np.float32) if use_cache else None
        sensor2egos = np.empty((F, N, 4, 4), np.float32)
        ego2globals = np.empty((F, N, 4, 4), np.float32)
        intrins = np.empty((F, N, 3, 3), np.float32)
        post_rots = np.empty((F, N, 3, 3), np.float32)
        post_trans = np.empty((F, N, 3), np.float32)

        # per-sample generator: numpy Generators are not thread-safe and
        # __getitem__ runs concurrently in the loader's decode threads;
        # seeding by (seed, index) also makes augs reproducible per sample
        rng = np.random.default_rng((self._seed, index))
        for ci, cam in enumerate(cfg.cams):
            cam_info = info["cams"][cam]
            img = open_image_native(self._path(cam_info["data_path"]))
            # per-camera aug, shared across the temporal frames of that
            # camera (PrepareImageInputs reuses resize_dims/crop/flip/rotate
            # for adjacent frames, loading.py:1275-1292)
            aug = T.sample_augmentation(cfg, (img.height, img.width),
                                        is_train=self.is_train, rng=rng)
            rot3, tran3 = T.aug_homography(aug)
            for f, frame in enumerate(frames):
                fci = frame["cams"][cam]
                fimg = img if f == 0 else open_image_native(self._path(fci["data_path"]))
                fimg = T.apply_image_aug(fimg, aug)
                imgs[f, ci] = (np.asarray(fimg) if self.raw_uint8
                               else T.normalize_clipsan(np.asarray(fimg)))
                if use_cache:
                    tok = frame["token"]
                    base = os.path.join(self.depth_cache_dir, tok[:2], tok,
                                        f"{tok}-{cam}")
                    depth_preds[f, ci] = _load_cached_depth(base)
                else:
                    dimg = fimg.resize((dW, dH), resample=Image.BICUBIC)
                    if (fdh, fdw) != (dH, dW):
                        dimg = dimg.resize((fdw, fdh), resample=Image.BICUBIC)
                    depth_imgs[f, ci] = (np.asarray(dimg) if self.raw_uint8
                                         else norm_depth(np.asarray(dimg)))
                s2e, e2g = self._cam_se3(fci)
                sensor2egos[f, ci] = s2e
                ego2globals[f, ci] = e2g
                intrins[f, ci] = np.asarray(cam_info["cam_intrinsic"], np.float32)
                post_rots[f, ci] = rot3
                post_trans[f, ci] = tran3

        lidarego2global = self._lidarego2global(info)
        prev = frames[1:] if F > 1 else [info]
        prev_lidarego2global = np.stack(
            [self._lidarego2global(fr) for fr in prev]
        ).astype(np.float32)
        cam2camego = sensor2egos[0]
        camego2global = ego2globals[0]

        # BDA sampled once per sample (LoadAnnotationsBEVDepth.__call__,
        # loading.py:1388-1420): geometry gets the matrix, occ GT the flips.
        # Rotation/scale have NO voxel-GT counterpart (the reference only
        # defines them for box GT; its occ recipes pin them to identity), so
        # allowing them here would silently de-correlate input and GT.
        bda_rot, bda_scale, flip_dx, flip_dy = T.sample_bda_augmentation(
            cfg, self.is_train, rng)
        if self.load_occ_gt and (bda_rot != 0.0 or bda_scale != 1.0):
            raise ValueError(
                "bda rot/scale augmentation is unsupported with voxel occ GT "
                "(no GT-side transform exists — reference loading.py:1411-1420 "
                "only flips); set bda_rot_lim=(0,0), bda_scale_lim=(1,1)")

        sample: Dict[str, Any] = {
            "token": info["token"],
            "imgs": imgs,
            "metas": {
                "sensor2egos": sensor2egos,
                "ego2globals": ego2globals,
                "intrins": intrins,
                "post_rots": post_rots,
                "post_trans": post_trans,
                "bda": T.bda_matrix(bda_rot, bda_scale, flip_dx, flip_dy),
                "lidarego2global": lidarego2global,
                "prev_lidarego2global": prev_lidarego2global,
                "cam2camego": cam2camego,
                "camego2global": camego2global,
            },
        }
        if use_cache:
            sample["depth_preds"] = depth_preds
        else:
            sample["depth_imgs"] = depth_imgs

        if self.load_occ_gt and "occ_path" in info:
            occ = np.load(os.path.join(self._path(info["occ_path"]), "labels.npz"))
            sample["voxel_semantics"] = occ["semantics"].astype(np.int32)
            sample["mask_lidar"] = occ["mask_lidar"].astype(np.int32)
            sample["mask_camera"] = occ["mask_camera"].astype(np.int32)
            T.flip_occ_gt(sample, flip_dx, flip_dy)

        if self.load_lidar_depth and info.get("lidar_path"):
            pts = _load_points(self._path(info["lidar_path"]))
            lidar2lidarego = T.se3(info["lidar2ego_rotation"],
                                   info["lidar2ego_translation"])
            l2i = lidar2img_matrices(lidar2lidarego, lidarego2global,
                                     cam2camego, camego2global, intrins[0])
            sample["gt_depth"] = points_to_multiview_depth(
                pts, l2i, post_rots[0], post_trans[0], H, W, self.grid
            )
        return sample

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, occ_results: Sequence[np.ndarray],
                 use_image_mask: bool = True) -> Dict[str, Any]:
        """Occ3D mIoU over the dataset (NuScenesDatasetOccpancy.evaluate,
        `nuscenes_dataset_occ.py:63-86`): reload GT per sample, accumulate the
        camera-masked confusion histogram, report per-class IoU + mean over
        the 17 non-free classes."""
        metric = MIoUMetric(use_image_mask=use_image_mask)
        for pred, info in zip(occ_results, self.infos):
            occ = np.load(os.path.join(self._path(info["occ_path"]), "labels.npz"))
            metric.add_batch(
                np.asarray(pred), occ["semantics"].astype(np.int32),
                mask_lidar=occ["mask_lidar"].astype(np.int32),
                mask_camera=occ["mask_camera"].astype(np.int32),
            )
        names, iou, miou = metric.count_miou()
        out: Dict[str, Any] = {"mIoU": miou}
        for i, name in enumerate(names[:-1]):
            out[f"IoU_{name}"] = float(iou[i] * 100)
        return out


def load_retrieval_csv(csv_path: str) -> List[Dict[str, str]]:
    """Parse a POP-3D `retrieval_anns_{split}.csv`
    (`nuscenes_dataset_retrieval.py:77-88`): ;-delimited rows of
    token;split;anno;matching_points;prompt, with anno / matching_points
    being .npy filenames relative to the csv's directory."""
    base = os.path.dirname(os.path.abspath(csv_path))
    items = []
    with open(csv_path, newline="") as f:
        for row in csv.reader(f, delimiter=";", quotechar="|"):
            if not row:
                continue
            token, split, anno, matching_points, prompt = row
            items.append({
                "token": token,
                "split": split,
                "prompt": prompt,
                "anno_file": os.path.join(base, anno),
                "points_file": os.path.join(base, matching_points),
            })
    return items


class NuScenesRetrievalDataset(NuScenesOccDataset):
    """POP-3D language-retrieval dataset (NuScenesDatasetRetrieval,
    `nuscenes_dataset_retrieval.py:39-139`): the occ dataset filtered to the
    retrieval benchmark's tokens, each sample carrying its free-text prompt,
    per-point binary annotations, the camera-visible point subset, and the
    per-point voxel indices (RetrievalForPointsIndices)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("load_occ_gt", False)
        super().__init__(*args, **kwargs)
        self._retrieval: List[Dict[str, Any]] = []

    def filter_to_retrieval(self, items: Sequence[Dict[str, Any]]) -> None:
        """Keep only infos whose token appears in `items` (order of items),
        attaching the retrieval metadata (filter_sequences,
        `nuscenes_dataset_retrieval.py:90-116`). Each item needs keys
        token / prompt / anno_file / points_file — `load_retrieval_csv`
        produces them from the published benchmark csv."""
        by_token = {info["token"]: info for info in self.infos}
        infos, metas = [], []
        for item in items:
            info = by_token.get(item["token"])
            if info is None:
                continue
            infos.append(info)
            metas.append(item)
        self.infos = infos
        self._retrieval = metas

    def filter_to_retrieval_csv(self, csv_path: str) -> None:
        self.filter_to_retrieval(load_retrieval_csv(csv_path))

    def __getitem__(self, index: int) -> Dict[str, Any]:
        sample = super().__getitem__(index)
        meta = self._retrieval[index]
        sample["retrieval_prompt"] = meta["prompt"]
        sample["retrieval_anno"] = np.load(meta["anno_file"]).reshape(-1)
        sample["matching_points"] = np.load(meta["points_file"]).reshape(-1)
        info = self.infos[index]
        pts = _load_points(self._path(info["lidar_path"]))
        lidar2lidarego = T.se3(info["lidar2ego_rotation"],
                               info["lidar2ego_translation"])
        sample["points_indices"] = points_to_voxel_indices(
            pts, lidar2lidarego, self.grid
        )
        return sample

    def evaluate_retrieval(self, results: Sequence[Dict[str, float]]) -> Dict[str, Any]:
        """Average per-prompt AP (x100) like the reference's PrettyTable
        summary (`nuscenes_dataset_retrieval.py:118-139`)."""
        maps = [r["map"] * 100 for r in results]
        vis = [r["map_visible"] * 100 for r in results]
        return {
            "mAP": float(np.nanmean(maps)) if maps else float("nan"),
            "mAP_visible": float(np.nanmean(vis)) if vis else float("nan"),
            "num_prompts": len(results),
        }
