"""LiDAR -> per-camera sparse depth GT and voxel pseudo-labels, in numpy
(counterpart of `veon_tpu/data/depth_gt.py`): projection into the
augmented images, per-pixel minimum depth, the occupancy pseudo-mask and
per-point voxel indices. `points_to_multiview_depth` takes the C++ host
library of `data/native.py` where it is built.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..configs.base import GridConfig


def project_points(
    points: np.ndarray,
    lidar2img: np.ndarray,
    post_rot: np.ndarray,
    post_tran: np.ndarray,
) -> np.ndarray:
    """Project lidar xyz to augmented-image (u, v, depth) for one camera.

    Matches the chain in PointToMultiViewDepth.__call__ (loading.py:816-828):
    p_img = lidar2img[:3] @ p; perspective divide; then the image-aug
    homography applied to the (u, v, depth) triple.

    Args:
      points: (P, 3) lidar-frame xyz.
      lidar2img: (4, 4) cam2img @ lidar2cam.
      post_rot: (3, 3); post_tran: (3,).

    Returns (P, 3) (u, v, depth) float32.
    """
    p = points[:, :3] @ lidar2img[:3, :3].T + lidar2img[:3, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        uvd = np.concatenate([p[:, :2] / p[:, 2:3], p[:, 2:3]], axis=1)
    uvd = uvd @ post_rot.T + post_tran[None, :]
    return uvd.astype(np.float32)


def points_to_depth_map(
    points_img: np.ndarray,
    height: int,
    width: int,
    grid: GridConfig,
    downsample: int = 1,
) -> np.ndarray:
    """(u, v, depth) triples -> (H/ds, W/ds) min-depth map.

    Matches points2depthmap (loading.py:735-759): round pixel coords at the
    downsampled resolution, keep depths in [d_min, d_max), per-pixel minimum
    wins (the reference's rank-sort + first-keep selects the same minimum).
    Empty pixels stay 0.
    """
    oh, ow = height // downsample, width // downsample
    coor = np.round(points_img[:, :2] / downsample)
    depth = points_img[:, 2]
    kept = (
        (coor[:, 0] >= 0)
        & (coor[:, 0] < ow)
        & (coor[:, 1] >= 0)
        & (coor[:, 1] < oh)
        & (depth >= grid.depth[0])
        & (depth < grid.depth[1])
        & np.isfinite(coor[:, 0])
        & np.isfinite(coor[:, 1])
    )
    out = np.zeros((oh, ow), np.float32)
    if not kept.any():
        return out
    coor = coor[kept].astype(np.int64)
    depth = depth[kept].astype(np.float32)
    flat = coor[:, 1] * ow + coor[:, 0]
    # per-pixel min via minimum.at on an inf-initialized buffer
    buf = np.full(oh * ow, np.inf, np.float32)
    np.minimum.at(buf, flat, depth)
    filled = np.isfinite(buf)
    out.reshape(-1)[filled] = buf[filled]
    return out


def lidar2img_matrices(
    lidar2lidarego: np.ndarray,
    lidarego2global: np.ndarray,
    cam2camego: np.ndarray,
    camego2global: np.ndarray,
    intrins: np.ndarray,
) -> np.ndarray:
    """Per-camera (N, 4, 4) lidar->image matrices.

    lidar2img = cam2img @ inv(camego2global @ cam2camego)
                        @ (lidarego2global @ lidar2lidarego)
    (loading.py:808-815).
    """
    N = cam2camego.shape[0]
    out = np.empty((N, 4, 4), np.float32)
    l2g = lidarego2global.astype(np.float64) @ lidar2lidarego.astype(np.float64)
    for n in range(N):
        cam2img = np.eye(4, dtype=np.float64)
        cam2img[:3, :3] = intrins[n]
        lidar2cam = np.linalg.inv(
            camego2global[n].astype(np.float64) @ cam2camego[n].astype(np.float64)
        ) @ l2g
        out[n] = (cam2img @ lidar2cam).astype(np.float32)
    return out


def points_to_multiview_depth(
    points: np.ndarray,
    lidar2img: np.ndarray,
    post_rots: np.ndarray,
    post_trans: np.ndarray,
    height: int,
    width: int,
    grid: GridConfig,
    downsample: int = 1,
) -> np.ndarray:
    """All-camera depth GT, preferring the native C++ plane when built."""
    from . import native

    if downsample == 1 and native.available():
        got = native.points_to_depth_native(
            points[:, :3], lidar2img, post_rots, post_trans,
            (height, width), (grid.depth[0], grid.depth[1]),
        )
        if got is not None:
            return got
    N = lidar2img.shape[0]
    out = np.zeros((N, height // downsample, width // downsample), np.float32)
    for n in range(N):
        uvd = project_points(points, lidar2img[n], post_rots[n], post_trans[n])
        out[n] = points_to_depth_map(uvd, height, width, grid, downsample)
    return out


def _voxelize_clamped(points_ego: np.ndarray, grid: GridConfig) -> np.ndarray:
    """floor-bin with top-edge clamp (shared by pseudo-mask + retrieval
    indices; loading.py:966-975 / :996-1010)."""
    nx, ny, nz = grid.size
    lb = np.array([grid.x[0], grid.y[0], grid.z[0]], np.float32)
    iv = np.array([grid.x[2], grid.y[2], grid.z[2]], np.float32)
    idx = np.floor((points_ego - lb) / iv)
    idx = np.minimum(idx, np.array([nx - 1, ny - 1, nz - 1], np.float64))
    idx = np.maximum(idx, 0)
    return idx.astype(np.int32)


def points_to_pseudo_mask(
    points: np.ndarray, lidar2lidarego: np.ndarray, grid: GridConfig
) -> np.ndarray:
    """LiDAR occupancy pseudo-label (PointToOccPseudoLabel, loading.py:946-984):
    transform to lidar-ego, keep points with lb < coord <= ub (strict lower,
    inclusive upper), floor-bin with top clamp, mark voxels occupied."""
    nx, ny, nz = grid.size
    p = points[:, :3] @ lidar2lidarego[:3, :3].T + lidar2lidarego[:3, 3]
    valid = (
        (p[:, 0] > grid.x[0]) & (p[:, 0] <= grid.x[1])
        & (p[:, 1] > grid.y[0]) & (p[:, 1] <= grid.y[1])
        & (p[:, 2] > grid.z[0]) & (p[:, 2] <= grid.z[1])
    )
    idx = _voxelize_clamped(p[valid], grid)
    mask = np.zeros((nx, ny, nz), np.uint8)
    mask[idx[:, 0], idx[:, 1], idx[:, 2]] = 1
    return mask


def points_to_voxel_indices(
    points: np.ndarray, lidar2lidarego: np.ndarray, grid: GridConfig
) -> np.ndarray:
    """Per-point voxel indices for retrieval AP (RetrievalForPointsIndices,
    loading.py:985-1014): every point gets a CLAMPED index (no filtering —
    the POP-3D annotations index points positionally)."""
    p = points[:, :3] @ lidar2lidarego[:3, :3].T + lidar2lidarego[:3, 3]
    return _voxelize_clamped(p, grid)
