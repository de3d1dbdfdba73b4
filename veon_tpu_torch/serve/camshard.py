"""Camera-sharded serving (counterpart of `veon_tpu/serve/camshard.py`
`make_camera_sharded_forward`, and of the request broadcast of JAX's
`serve --cam-shards`): each rank of a cam group (`collectives.py`
`CamGroup`, one process per card) runs the model on its block of the
cameras; `model/camshard.py` cuts the blocks, prepares the rig's metas
(`prepare_camshard_metas`) and gathers the per-camera outputs. With one
card shared by several ranks the group's backend is gloo, which sums
through the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..collectives import CamGroup
from ..model.camshard import gather_outputs, local_inputs


def make_camera_sharded_forward(model, cam_group: CamGroup, method: str = "full_forward"):
    """The camera-sharded forward of `model`, which this shards over
    `cam_group` in place (`VeonModel.set_cam_group`).

    Returns fn(imgs, depth_imgs, metas, ov_weight) -> the outputs of
    `VeonModel.full_forward` on the whole ring: each rank runs its cameras,
    the per-camera leaves are gathered, the voxel leaves are the same on
    every rank. `metas` come from `prepare_camshard_metas`.
    `method="forward"` skips the depth tower and takes metric depth
    (B, F, N, H/2, W/2) as the second argument."""
    model.set_cam_group(cam_group)
    run = model if method in ("forward", "__call__") else getattr(model, method)

    def forward(imgs, depth_imgs, metas, ov_weight):
        imgs, depth_imgs, metas = local_inputs(imgs, depth_imgs, metas, cam_group)
        return gather_outputs(run(imgs, depth_imgs, metas, ov_weight), cam_group)

    return forward


def share_request(req, cg: CamGroup, device):
    """The group's first rank sends `req` (a request's tensors by name as
    numpy arrays or tensors, or None, which ends the others' loop) and
    every rank returns it as tensors on `device`, in one object broadcast
    of the names, dtypes and shapes and one broadcast per tensor."""
    src = dist.get_global_rank(cg.group, 0)
    leader = dist.get_rank() == src
    if leader and req is not None:
        req = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
               for k, v in req.items()}
    head = [None if req is None else {k: (v.dtype, tuple(v.shape)) for k, v in req.items()}
            ] if leader else [None]
    dist.broadcast_object_list(head, src=src, group=cg.group)
    if head[0] is None:
        return None
    out = {}
    for k, (dtype, shape) in head[0].items():
        t = req[k].to(device).contiguous() if leader else torch.empty(shape, dtype=dtype,
                                                                       device=device)
        dist.broadcast(t, src=src, group=cg.group)
        out[k] = t
    return out
