"""Camera frustum geometry and voxel ranks (counterpart of
`veon_tpu/geometry/frustum.py`).

Voxel binning is sensitive to the last bit of the ego coordinates, so
everything here runs in fp32 and the small 3x3 contractions are written
out as elementwise products and sums: no matmul, hence no TF32 and no
device-dependent reduction order. The 3x3 inverses run on the host (LAPACK,
as the JAX reference on the CPU), so the rank stream is the same on the
CPU and on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..configs.base import GridConfig


def create_frustum(grid: GridConfig, input_size: Tuple[int, int],
                   downsample: int, sid: bool = False) -> np.ndarray:
    """(D, Hf, Wf, 3) template of (x_pix, y_pix, depth_m) per frustum point;
    depth spans the bin lower edges arange(d0, d1, dd), or with sid=True the
    Spacing-Increasing Discretization planes (`lift/lss.py`
    `sid_depth_values`, `view_transformer_raw.py:107-112`)."""
    h_in, w_in = input_size
    hf, wf = h_in // downsample, w_in // downsample
    d = np.arange(grid.depth[0], grid.depth[1], grid.depth[2], dtype=np.float32)
    if sid:
        from ..lift.lss import sid_depth_values

        d = sid_depth_values(grid)
    frustum = np.empty((d.shape[0], hf, wf, 3), dtype=np.float32)
    frustum[..., 0] = np.linspace(0, w_in - 1, wf, dtype=np.float32)[None, None, :]
    frustum[..., 1] = np.linspace(0, h_in - 1, hf, dtype=np.float32)[None, :, None]
    frustum[..., 2] = d[:, None, None]
    return frustum


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m (..., 3, 3) applied to v (..., 3), leading dims broadcast:
    out_i = (m_i0 v_0 + m_i1 v_1) + m_i2 v_2."""
    rows = [(m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]) + m[..., i, 2] * v[..., 2]
            for i in range(3)]
    return torch.stack(rows, -1)


def _inv(m: torch.Tensor) -> torch.Tensor:
    """fp32 inverse of (..., n, n) computed on the host (LU, as the JAX
    reference's jnp.linalg.inv on the CPU)."""
    return torch.linalg.inv(m.detach().cpu().float()).to(m.device)


def _expand(m: torch.Tensor, extra: int) -> torch.Tensor:
    """(B, N, 3, 3) -> (B, N, 1.., 3, 3) with `extra` singleton point dims."""
    return m.reshape(m.shape[:-2] + (1,) * extra + m.shape[-2:])


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) written out elementwise."""
    return torch.stack([_matvec(a, b[..., :, j]) for j in range(3)], -1)


def frustum_to_ego(frustum, sensor2ego, cam2img, post_rot, post_tran, bda) -> torch.Tensor:
    """Frustum points -> key-ego xyz, (B, N, D, Hf, Wf, 3):
    undo the image augmentation, unproject, camera -> ego, then BDA."""
    f32 = torch.float32
    pts = frustum[None, None].to(f32) - post_tran[:, :, None, None, None, :].to(f32)
    pts = _matvec(_expand(_inv(post_rot), 3), pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
    combine = _matmul3(sensor2ego[:, :, :3, :3].to(f32), _inv(cam2img))
    pts = _matvec(_expand(combine, 3), pts)
    pts = pts + sensor2ego[:, :, None, None, None, :3, 3].to(f32)
    return _matvec(bda.to(f32).reshape(bda.shape[0], 1, 1, 1, 1, 3, 3), pts)


def pixel_ray_geometry(input_size, downsample: int, sensor2ego, cam2img, post_rot,
                       post_tran, bda):
    """Per-pixel rays: the ego xyz of the frustum point of pixel (u, v) at
    metric depth d is d * dirs[..., v, u, :] + origin[..., None, None, :].
    Returns dirs (B, N, Hf, Wf, 3) and origin (B, N, 3), fp32."""
    f32 = torch.float32
    h_in, w_in = input_size
    hf, wf = h_in // downsample, w_in // downsample
    uv = np.empty((hf, wf, 2), np.float32)
    uv[..., 0] = np.linspace(0, w_in - 1, wf, dtype=np.float32)[None, :]
    uv[..., 1] = np.linspace(0, h_in - 1, hf, dtype=np.float32)[:, None]
    p2 = torch.from_numpy(uv).to(sensor2ego.device)[None, None] - post_tran[:, :, None, None, :2].to(f32)
    inv2 = _expand(_inv(post_rot[:, :, :2, :2]), 2)
    ab = torch.stack([inv2[..., i, 0] * p2[..., 0] + inv2[..., i, 1] * p2[..., 1]
                      for i in range(2)], -1)
    vec = torch.cat([ab, torch.ones_like(ab[..., :1])], -1)
    rot = sensor2ego[:, :, :3, :3].to(f32)
    combine = _matmul3(_matmul3(bda.to(f32)[:, None], rot), _inv(cam2img))
    dirs = _matvec(_expand(combine, 2), vec)
    origin = _matvec(bda.to(f32)[:, None], sensor2ego[:, :, :3, 3].to(f32))
    return dirs, origin


def voxel_ranks(coor_ego: torch.Tensor, grid: GridConfig):
    """int32 flat voxel rank ((b*nz + z)*ny + y)*nx + x per point, out-of-grid
    points mapped to the overflow cell B*nz*ny*nx."""
    nx, ny, nz = grid.size
    lb = torch.tensor(grid.lower_bound, dtype=coor_ego.dtype, device=coor_ego.device)
    # multiply by the fp32 reciprocal of the interval: XLA rewrites the
    # reference's division by a constant that way, and a point on a cell
    # boundary bins differently under the two roundings
    inv_iv = 1.0 / torch.tensor(grid.interval, dtype=torch.float32)
    scaled = (coor_ego - lb) * inv_iv.to(coor_ego.device)
    vox = scaled.to(torch.int32)  # truncation toward zero, as torch .long()
    valid = ((scaled >= 0).all(-1) & (vox[..., 0] < nx) & (vox[..., 1] < ny)
             & (vox[..., 2] < nz))
    B = coor_ego.shape[0]
    b = torch.arange(B, dtype=torch.int32, device=coor_ego.device).reshape(B, 1, 1, 1, 1)
    rank = ((b * nz + vox[..., 2]) * ny + vox[..., 1]) * nx + vox[..., 0]
    return torch.where(valid, rank, torch.full_like(rank, B * nz * ny * nx))


def se3_inverse(m: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of rigid (..., 4, 4): [R t; 0 1]^-1 = [R^T -R^T t; 0 1]."""
    rt = m[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(m)
    out[..., :3, :3] = rt
    out[..., :3, 3] = -_matvec(rt, m[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def compose_se3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for (..., 4, 4) in fp32 without TF32."""
    cols = [sum(a[..., :, k] * b[..., k, j, None] for k in range(4)) for j in range(4)]
    return torch.stack(cols, -1)


def sensor2keyego_chain(sensor2egos, ego2globals, num_frames: int, num_cams: int):
    """Per-frame sensor -> key-ego transforms (B, F, N, 4, 4), each frame
    anchored at its own first camera's ego:
    sensor2keyego = keyego2global^-1 @ ego2global @ sensor2ego."""
    B = sensor2egos.shape[0]
    s2e = sensor2egos.reshape(B, num_frames, num_cams, 4, 4).float()
    e2g = ego2globals.reshape(B, num_frames, num_cams, 4, 4).float()
    global2keyego = se3_inverse(e2g[:, :, 0])[:, :, None]
    return compose_se3(compose_se3(global2keyego, e2g), s2e)
