"""Visualization helpers (counterpart of `veon_tpu/utils/vis.py`, kept as
the port's own numpy copy): depth colormaps, camera grids, BEV and
height-slice occupancy images, the voxel point cloud (PLY and NPY) and the
2D semantic overlays of `mmdet3d/utils/vis.py` and the BEV rendering of
`nuscenes_dataset_occ.py:88-108`. numpy and PIL only."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# Occ3D-nuScenes display palette, one RGB per class (free = transparent/black)
OCC_PALETTE = np.array(
    [
        [0, 0, 0],        # others
        [255, 120, 50],   # barrier
        [255, 192, 203],  # bicycle
        [255, 255, 0],    # bus
        [0, 150, 245],    # car
        [0, 255, 255],    # construction_vehicle
        [255, 127, 0],    # motorcycle
        [255, 0, 0],      # pedestrian
        [255, 240, 150],  # traffic_cone
        [135, 60, 0],     # trailer
        [160, 32, 240],   # truck
        [255, 0, 255],    # driveable_surface
        [139, 137, 137],  # other_flat
        [75, 0, 75],      # sidewalk
        [150, 240, 80],   # terrain
        [230, 230, 250],  # manmade
        [0, 175, 0],      # vegetation
        [255, 255, 255],  # free
    ],
    dtype=np.uint8,
)


def colorize_depth(depth: np.ndarray, d_min: Optional[float] = None,
                   d_max: Optional[float] = None) -> np.ndarray:
    """(H, W) metric depth -> (H, W, 3) uint8 turbo-ish colormap."""
    d = np.asarray(depth, dtype=np.float64)
    d_min = float(np.nanmin(d)) if d_min is None else d_min
    d_max = float(np.nanmax(d)) if d_max is None else d_max
    t = np.clip((d - d_min) / max(d_max - d_min, 1e-9), 0, 1)
    # simple 4-stop gradient: dark blue -> cyan -> yellow -> red
    stops = np.array([[0, 0, 128], [0, 255, 255], [255, 255, 0], [255, 0, 0]],
                     dtype=np.float64)
    idx = np.clip(t * 3, 0, 3 - 1e-9)
    lo = idx.astype(int)
    frac = (idx - lo)[..., None]
    rgb = stops[lo] * (1 - frac) + stops[lo + 1] * frac
    return rgb.astype(np.uint8)


def vis_occ_bev(occ: np.ndarray, free_idx: int = 17) -> np.ndarray:
    """(X, Y, Z) class grid -> (Y, X, 3) BEV image: per column, the highest
    non-free voxel's class (the reference's BEV rendering convention)."""
    occ = np.asarray(occ)
    X, Y, Z = occ.shape
    nonfree = occ != free_idx
    # index of the topmost occupied voxel per (x, y); free where none
    top = Z - 1 - np.argmax(nonfree[..., ::-1], axis=-1)
    any_occ = nonfree.any(axis=-1)
    cls = np.where(any_occ, np.take_along_axis(occ, top[..., None], axis=-1)[..., 0],
                   free_idx)
    img = OCC_PALETTE[np.clip(cls, 0, len(OCC_PALETTE) - 1)]
    return np.transpose(img, (1, 0, 2))  # (Y, X, 3)


def vis_occ_height_slices(occ: np.ndarray, free_idx: int = 17) -> np.ndarray:
    """(X, Y, Z) class grid -> horizontal strip of per-height BEV slices."""
    occ = np.asarray(occ)
    X, Y, Z = occ.shape
    slices = [OCC_PALETTE[np.clip(occ[:, :, z], 0, len(OCC_PALETTE) - 1)].transpose(1, 0, 2)
              for z in range(Z)]
    return np.concatenate(slices, axis=1)


def camera_grid(images: Sequence[np.ndarray], cols: int = 3) -> np.ndarray:
    """Stack (H, W, 3) uint8 camera images into a rows x cols grid."""
    imgs = [np.asarray(im) for im in images]
    H, W = imgs[0].shape[:2]
    rows = (len(imgs) + cols - 1) // cols
    canvas = np.zeros((rows * H, cols * W, 3), dtype=np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        canvas[r * H:(r + 1) * H, c * W:(c + 1) * W] = im[..., :3]
    return canvas


def denormalize_clipsan(img: np.ndarray) -> np.ndarray:
    """Invert data.transforms.normalize_clipsan back to RGB uint8."""
    mean = np.array([122.7709, 116.7460, 104.0937], np.float32)
    std = np.array([68.5005, 66.6322, 70.3232], np.float32)
    x = np.asarray(img, np.float32) * std + mean
    return np.clip(x[..., ::-1], 0, 255).astype(np.uint8)  # undo channel swap


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(img)).save(path)


def vis_occ_pointcloud(
    occ: np.ndarray,
    grid_range: Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]] = (
        (-40.0, 40.0), (-40.0, 40.0), (-1.0, 5.4)),
    free_idx: int = 17,
    ply_path: Optional[str] = None,
    npy_path: Optional[str] = None,
) -> np.ndarray:
    """3D occupancy point-cloud export (`mmdet3d/utils/vis.py:182+` vis_occ).

    Emits one colored point per occupied voxel at its metric center, exactly
    the reference's open3d export — but as a self-contained ASCII PLY (any
    viewer opens it; no open3d dependency) plus the same (P, 4) xyz+class
    `.npy` vertices array.

    Args:
      occ: (X, Y, Z) int class grid (free/ignore = free_idx and above).
      grid_range: metric ((x0,x1),(y0,y1),(z0,z1)) of the voxel volume.
    Returns the (P, 4) float32 vertices (x, y, z, class).
    """
    occ = np.asarray(occ)
    sel = occ < free_idx
    idx = np.stack(np.nonzero(sel), axis=-1).astype(np.float32)  # (P, 3)
    shape = np.asarray(occ.shape, np.float32)
    lo = np.asarray([r[0] for r in grid_range], np.float32)
    hi = np.asarray([r[1] for r in grid_range], np.float32)
    xyz = (idx + 0.5) * (hi - lo) / shape + lo
    cls = occ[sel].astype(np.float32)
    vertices = np.concatenate([xyz, cls[:, None]], axis=-1)
    if npy_path is not None:
        np.save(npy_path, vertices)
    if ply_path is not None:
        rgb = OCC_PALETTE[np.clip(cls.astype(int), 0, len(OCC_PALETTE) - 1)]
        with open(ply_path, "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(vertices)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\n"
                    "property uchar blue\nend_header\n")
            for (x, y, z), (r, g, b) in zip(xyz, rgb):
                f.write(f"{x:.3f} {y:.3f} {z:.3f} {r} {g} {b}\n")
    return vertices


def semseg_overlay(image_rgb: np.ndarray, sem_seg: np.ndarray,
                   num_classes: int, alpha: float = 0.5,
                   mode: str = "overlay") -> np.ndarray:
    """2D semantic-segmentation debug view
    (`san_in_veon_entry_temporal.py:172-241` visualize): blend a per-pixel
    class map over the denormalized camera image ("overlay") or render the
    flat class-color mask ("mask"). Colors are seeded like the reference
    (np.random.seed(0) per-class random colors) so runs are comparable.

    image_rgb: (H, W, 3) uint8; sem_seg: (h, w) int class ids (resized to
    the image size with nearest neighbor if smaller).
    """
    rng = np.random.RandomState(0)
    colors = rng.randint(0, 256, size=(num_classes, 3)).astype(np.uint8)
    sem = np.asarray(sem_seg)
    H, W = image_rgb.shape[:2]
    if sem.shape != (H, W):  # nearest-neighbor upsample to image size
        ry = (np.arange(H) * sem.shape[0] // H).clip(0, sem.shape[0] - 1)
        rx = (np.arange(W) * sem.shape[1] // W).clip(0, sem.shape[1] - 1)
        sem = sem[ry[:, None], rx[None, :]]
    mask = colors[np.clip(sem, 0, num_classes - 1)]
    if mode == "mask":
        return mask
    out = (1 - alpha) * image_rgb.astype(np.float32) + alpha * mask.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)
