"""The camera slicing of camera-sharded serving and training (counterpart
of the metas and per-shard parts of `veon_tpu/serve/camshard.py`): the
six-camera ring split over the ranks of a cam group (`collectives.py`
`CamGroup`, one process per card), rank order = camera order.

Everything in the VEON graph before the voxel splat is per camera: the
depth tower, the CLIP trunk, the side adapter, the rec head, HSA and the
lift fusion. So each rank runs them on its block of N / S cameras and
lifts that block's points; the lift sums the ranks' full-resolution grids
(`collectives.cam_sum`) before its [2,2,2] max-pool, since max does not
commute with the cross-camera sum, and the 3D stage then runs on the same
grid on every rank. The per-camera outputs come back to every rank
through `collectives.cam_gather` (`gather_outputs`).

Every rank holds the whole request or batch (a server's rank 0 broadcasts
each request, `serve/camshard.py`; a trainer's batch row loads the same
batch on each of its cam ranks, `train/step.py`) and cuts its own cameras
from it (`local_inputs`, `local_batch`), as JAX's shard_map cuts them by
its in_specs.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..collectives import CamGroup, cam_gather
from ..configs.base import VeonConfig
from ..geometry.frustum import sensor2keyego_chain
from ..lift.lss import LSSLift
from .veon import PER_CAMERA_OUTPUTS

# metas leaves laid out (B, F, N, ...): the camera axis is 2
_CAM_AXIS2 = ("sensor2egos", "ego2globals", "intrins", "post_rots", "post_trans",
              "sensor2keyegos")
# metas leaves laid out (B, N, ...): axis 1
_CAM_AXIS1 = ("cam2camego", "camego2global")
# batch leaves laid out (B, F, N, ...)
_BATCH_CAM_AXIS2 = ("imgs", "depth", "depth_imgs", "depth_preds")


def prepare_camshard_metas(cfg: VeonConfig, metas: Dict[str, Any], num_shards: int,
                           presort: bool = False) -> Dict[str, Any]:
    """A metas dict made camera-shardable.

    * Pins `sensor2keyegos` (B, F, N, 4, 4) computed from the whole rig: the
      per-frame keyego anchor is the rig's cam-0 ego, which a shard whose
      first camera is another cannot compute.
    * With `presort` (a fixed rig's F=1 serving): each shard's
      `LSSLift.precompute_sorted(fuse_ds_pool=False)` on its own cameras,
      each stream padded to the longest with order 0 and rank num_cells
      (rows that land past the last cell, so the padding adds nothing),
      stacked as "lift_sorted": order / rk_sorted (S, P) and ranks
      (B, N, D, h, w), the shards' blocks side by side.
    """
    metas = dict(metas)
    s2e = metas["sensor2egos"]
    B, F, N = s2e.shape[:3]
    if N % num_shards != 0:
        raise ValueError(f"{N} cameras not divisible by --cam-shards {num_shards}")
    metas["sensor2keyegos"] = sensor2keyego_chain(
        s2e.reshape(B, F * N, 4, 4), metas["ego2globals"].reshape(B, F * N, 4, 4), F, N)
    if not presort:
        metas.pop("lift_sorted", None)
        return metas
    if F != 1:
        raise ValueError("presorted lift applies to F=1 serving only")
    lift = LSSLift.from_config(cfg)
    num_cells = B * int(np.prod(cfg.grid.size))
    nl = N // num_shards
    pre = []
    for i in range(num_shards):
        sl = slice(i * nl, (i + 1) * nl)
        # the flat layout: the shards' grids are summed at full resolution
        # before the max-pool, which the fused layout would take first
        pre.append(lift.precompute_sorted(
            metas["sensor2keyegos"][:, 0, sl], metas["intrins"][:, 0, sl],
            metas["post_rots"][:, 0, sl], metas["post_trans"][:, 0, sl], metas["bda"],
            fuse_ds_pool=False))
    p_max = max(p["order"].shape[0] for p in pre)

    def pad(x, fill):
        return torch.nn.functional.pad(x, (0, p_max - x.shape[0]), value=fill)

    metas["lift_sorted"] = {
        "order": torch.stack([pad(p["order"], 0) for p in pre]),
        "rk_sorted": torch.stack([pad(p["rk_sorted"], num_cells) for p in pre]),
        "ranks": torch.cat([p["ranks"] for p in pre], dim=1),
    }
    return metas


def shard_local_lift_sorted(metas: Dict[str, Any], index: int) -> Dict[str, Any]:
    """Shard `index`'s row of the stacked presorted streams of
    `prepare_camshard_metas(presort=True)`; its block of "ranks" is cut by
    `local_metas` with the other camera leaves."""
    if "lift_sorted" not in metas:
        return metas
    metas = dict(metas)
    ls = metas["lift_sorted"]
    metas["lift_sorted"] = {"order": ls["order"][index], "rk_sorted": ls["rk_sorted"][index],
                            "ranks": ls["ranks"]}
    return metas


def local_cameras(x: torch.Tensor, axis: int, cg: CamGroup) -> torch.Tensor:
    """This rank's block of the camera axis `axis` of x."""
    n = x.shape[axis] // cg.size
    return x.narrow(axis, cg.index * n, n)


def local_metas(metas: Dict[str, Any], cg: CamGroup) -> Dict[str, Any]:
    """This rank's cameras of every camera leaf of metas (and its row of a
    stacked presort); the other leaves as they are."""
    if "lift_sorted" in metas and metas["lift_sorted"]["order"].dim() != 2:
        raise ValueError(
            "camera-sharded session needs per-shard stacked presorted "
            "streams — build rig_metas with "
            "prepare_camshard_metas(..., presort=True)")
    if "sensor2keyegos" not in metas:
        raise ValueError("camera-sharded metas need the whole rig's sensor2keyegos: "
                         "build them with prepare_camshard_metas")
    out = {}
    for k, v in shard_local_lift_sorted(metas, cg.index).items():
        if k in _CAM_AXIS2:
            v = local_cameras(v, 2, cg)
        elif k in _CAM_AXIS1:
            v = local_cameras(v, 1, cg)
        elif k == "lift_sorted":
            v = dict(v, ranks=local_cameras(v["ranks"], 1, cg))
        out[k] = v
    return out


def local_inputs(imgs, depth_imgs, metas, cg: CamGroup):
    """This rank's cameras of a request: imgs and depth_imgs (or metric
    depth) (B, F, N, ...) and metas."""
    return local_cameras(imgs, 2, cg), local_cameras(depth_imgs, 2, cg), local_metas(metas, cg)


def local_batch(batch: Dict[str, Any], cg: CamGroup) -> Dict[str, Any]:
    """This rank's cameras of a training batch (images, depth, depth-tower
    images or cached depth, metas); labels and scalars as they are."""
    out = dict(batch)
    for k in _BATCH_CAM_AXIS2:
        if k in out:
            out[k] = local_cameras(out[k], 2, cg)
    out["metas"] = local_metas(batch["metas"], cg)
    return out


def gather_outputs(out: Dict[str, torch.Tensor], cg: CamGroup) -> Dict[str, torch.Tensor]:
    """The per-camera output leaves gathered to the whole ring (camera axis
    1); the voxel leaves, equal on every rank, as they are."""
    return {k: cam_gather(v, 1, cg) if k in PER_CAMERA_OUTPUTS else v for k, v in out.items()}
