"""How `correct` is decided: the plain reference (`reference/`, fp32 with
TF32 off) run on the same seeded weights and frames as the port, and the
numbers that compare the two. Which numbers a cell compares, and their
limits, are in `limits/<cell>.json`; the others are readings.

A served request is judged in two stages, each against the reference.
The run keeps, for the requests it judges (one drawn from the seed and the
last), the frame's lifted voxels, the raw outputs and the served grid, and
of a streaming session the voxels it held before the request: a
streaming session's are the voxels it cached, the single-frame server's
those its 3D head took.

- The lift and what feeds it (the depth tower, the CLIP and SAN towers,
  HSA, the lift over the rig's presort): the program's voxels against the
  reference's own voxels of that frame (`early`). `vox_relerr` is the
  relative L2 error of their per-channel means; `vox_tile_relerr` that of
  their per-channel means over 3 x 3 tiles of the ground plane (all
  heights in one), which moves when mass lands in another part of the
  grid. Finer than that the lift is not
  steady: the two-hot lift over 0.5 m depth bins turns the depth tower's
  bf16 rounding into mass moved between neighbouring cells.
- After the lift (the warp and the temporal fusion of a streaming
  session, the 3D head, the open-vocabulary product): the reference's
  `head` run on the program's own voxels of the frame (and of the frame
  before), against the program's raw outputs. `sem_relerr` is the
  relative L2 error of the open-vocabulary logits `sem_occ_raw`,
  `occ_relerr` that of the occupancy logit (occupied less free).
- The served grid: `pred_mismatch`, the share of voxels where the served
  grid differs from the class merge and fusion rule applied to the step's
  own raw outputs; an exact comparison.

The control: the reference computed as the program computes, in the
configuration's bf16, with every matmul, convolution and attention
operand rounded further to fp8 e4m3 (`fake_quant`, per-tensor scales):
the next precision below bf16 in its products and nowhere above the
program's; judged the same way by the fp32 reference.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np

from .harness import config_from_file, make_weights, rig_metas

TILES = 3  # bird's-eye tiles per side of `vox_tile_relerr`


def _round_fp8(torch, x):
    """x rounded to fp8 e4m3 with a per-tensor scale, in x's dtype."""
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return x
    dtype = torch.float8_e4m3fn
    amax = x.abs().amax().float().clamp_min(1e-12)
    scale = amax / torch.finfo(dtype).max
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


@contextlib.contextmanager
def fake_quant():
    """Round the operands of every matmul, convolution and attention to
    fp8 e4m3 (per-tensor scale, accumulation in the operands' dtype)."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    two = {F.linear, F.conv1d, F.conv2d, F.conv3d, F.conv_transpose2d, F.conv_transpose3d}
    allq = {torch.matmul, torch.bmm, torch.mm, torch.Tensor.__matmul__, torch.Tensor.matmul,
            torch.Tensor.bmm, torch.Tensor.mm}
    three = {F.scaled_dot_product_attention}

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in two:
                args = (_round_fp8(torch, args[0]), _round_fp8(torch, args[1])) + tuple(args[2:])
            elif func in allq:
                args = tuple(_round_fp8(torch, a) for a in args)
            elif func in three:
                args = tuple(_round_fp8(torch, a) for a in args[:3]) + tuple(args[3:])
            elif func is torch.einsum:
                args = (args[0],) + tuple(
                    [_round_fp8(torch, t) for t in a] if isinstance(a, (list, tuple))
                    else _round_fp8(torch, a) for a in args[1:])
            return func(*args, **kwargs)

    with Mode():
        yield


def relerr(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def tile_mean(torch, vox, tiles: int = TILES):
    """(1, Z, Y, X, C) voxels -> (C, tiles, tiles): each channel's mean over
    all heights and a tiles x tiles partition of the ground plane."""
    v = vox.float()[0].permute(3, 0, 1, 2)  # (C, Z, Y, X)
    return torch.nn.functional.adaptive_avg_pool3d(v, (1, tiles, tiles))[:, 0]


class RefServing:
    """The reference serving model of one cell at one seed (fp32 with TF32
    off, or the control's `compute_dtype`): its own weights from the seed,
    rig presort, class merge and open-vocabulary matrix."""

    def __init__(self, conf: Dict, num_temporal: int, seed: int, device,
                 compute_dtype: str = "float32"):
        import torch
        from .reference import no_tf32
        from .reference.configs import base
        from .reference.geometry.frustum import sensor2keyego_chain
        from .reference.nn import text

        self.torch = torch
        dev = torch.device(device)
        if dev.type == "cuda":
            no_tf32()
        self.dev = dev
        self.cfg = cfg = config_from_file(base, conf, num_temporal, compute_dtype)
        self.model = make_weights(cfg, seed, dev)
        self.num_temporal = num_temporal
        prompts, refl = text.build_vocabulary(cfg.vocabulary)
        self.membership = text.merge_matrix(refl)
        # the open-vocabulary matrix that serving without a text tower uses:
        # N(0, 1) from numpy's default_rng(0)
        self.ovw = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)).to(dev)
        rig = {k: torch.from_numpy(v).to(dev) for k, v in rig_metas(cfg).items()}
        N = cfg.data.num_cams
        s2k = sensor2keyego_chain(rig["sensor2egos"].reshape(1, -1, 4, 4),
                                  rig["ego2globals"].reshape(1, -1, 4, 4), 1, N)
        with torch.no_grad():
            rig["lift_sorted"] = self.model.lift.precompute_sorted(
                s2k[:, 0], rig["intrins"][:, 0], rig["post_rots"][:, 0],
                rig["post_trans"][:, 0], rig["bda"])
        self.rig = rig
        nx, ny, nz = cfg.grid.size
        dz, dy, dx = cfg.lss_feat_ds
        self.vox_shape = (nz // dz, ny // dy, nx // dx, cfg.propagation.dim)

    def _t(self, x):
        return self.torch.as_tensor(np.asarray(x)).to(self.dev)

    def _inputs(self, frame):
        from .reference.data.transforms import normalize_in_graph
        imgs = normalize_in_graph(self._t(frame["imgs"]), "clipsan")
        d = normalize_in_graph(self._t(frame["depth_imgs"]), self.cfg.data.depth_norm_method)
        return imgs, d

    def early(self, frame):
        """The voxels a session caches for `frame` (forward_early)."""
        with self.torch.no_grad():
            imgs, d = self._inputs(frame)
            return self.model.forward_early(imgs, self.model.estimate_depth(d), self.rig)

    def step(self, frame, prev_frame=None, prev_vox=None):
        """The served step on `frame`, with the previous frame's voxels for
        a streaming session: the raw outputs, `early_vox` and the served
        grid `pred`."""
        t = self.torch
        with t.no_grad():
            imgs, d = self._inputs(frame)
            metas = dict(self.rig)
            if prev_vox is None:  # a single frame: no previous frame to fuse
                prev_vox = t.zeros((0,), device=self.dev).reshape((1, 0) + self.vox_shape)
                prev_l2g = t.zeros((1, 0, 4, 4), device=self.dev)
            else:
                metas["lidarego2global"] = self._t(frame["lidarego2global"])
                prev_vox = prev_vox[:, None]
                prev_l2g = self._t(prev_frame["lidarego2global"])[:, None]
            out = self.model.full_forward_streaming(imgs, d, metas, self.ovw, prev_vox, prev_l2g)
            out["pred"] = self.pred(out)
            return out

    def head(self, vox, prev_vox=None, frame=None, prev_frame=None):
        """The 3D head on `vox` (with a streaming session's `prev_vox`
        warped into `frame`'s ego): bin_occ and sem_occ_raw, fp32."""
        t = self.torch
        with t.no_grad():
            prevs = [] if prev_vox is None else [self.model.align_to_prev(
                self._t(prev_vox).float(), self._t(frame["lidarego2global"]),
                self._t(prev_frame["lidarego2global"]))]
            bin_occ, _feat, sem = self.model.voxel_head(self._t(vox).float(), prevs, self.ovw)
        return bin_occ.float(), sem.float()

    def pred(self, out):
        from .reference.model.veon import fused_classes
        return fused_classes(out, self.membership).to(self.torch.uint8)


def serving_numbers(ref: RefServing, frames: List[Dict], kept: Dict[int, Dict]
                    ) -> Dict[str, float]:
    """The numbers of one run, each the worst over the judged requests:
    `kept[k]` holds request k's `vox` (1, Z, Y, X, C), of a streaming
    session its `prev_vox` too, the raw `bin_occ` and `sem_occ_raw`, and
    the served grid `pred`."""
    t = ref.torch
    nums = {"vox_relerr": 0.0, "vox_tile_relerr": 0.0, "sem_relerr": 0.0, "occ_relerr": 0.0,
            "pred_mismatch": 0.0}
    if not kept:
        return {k: float("inf") for k in nums}

    def worst(name, v):
        nums[name] = max(nums[name], v if np.isfinite(v) else float("inf"))

    for k, rec in sorted(kept.items()):
        got = ref._t(rec["vox"]).float()
        want = ref.early(frames[k]).float().reshape(got.shape)
        worst("vox_relerr", relerr(got.mean((0, 1, 2, 3)), want.mean((0, 1, 2, 3))))
        worst("vox_tile_relerr", relerr(tile_mean(t, got), tile_mean(t, want)))
        del want
        prev = rec.get("prev_vox")
        bin_occ, sem = ref.head(rec["vox"], prev, frames[k], frames[k - 1] if k else None)
        got_bin, got_sem = ref._t(rec["bin_occ"]).float(), ref._t(rec["sem_occ_raw"]).float()
        worst("sem_relerr", relerr(got_sem, sem))
        worst("occ_relerr", relerr(got_bin[..., 0] - got_bin[..., 1],
                                   bin_occ[..., 0] - bin_occ[..., 1]))
        fused = ref.pred({"bin_occ": got_bin, "sem_occ_raw": got_sem})
        served = ref._t(rec["pred"]).reshape(fused.shape)
        worst("pred_mismatch", float((served != fused).float().mean()))
        del bin_occ, sem, got_bin, got_sem, fused
    return nums


def control_serving_numbers(ref: RefServing, ctl: RefServing, frames: List[Dict],
                            checked: List[int]) -> Dict[str, float]:
    """The same numbers for the control `ctl` (the reference in bf16) run
    under `fake_quant` in the program's place on the same requests."""
    kept = {}
    for k in checked:
        with fake_quant():
            prev = ctl.early(frames[k - 1]) if ctl.num_temporal > 1 else None
            out = ctl.step(frames[k], frames[k - 1], prev)
        kept[k] = {"vox": out["early_vox"].float().cpu().numpy(),
                   "bin_occ": out["bin_occ"].cpu().numpy(),
                   "sem_occ_raw": out["sem_occ_raw"].cpu().numpy(),
                   "pred": out["pred"].cpu().numpy()}
        if prev is not None:
            kept[k]["prev_vox"] = prev.float().cpu().numpy()
        del out, prev
    return serving_numbers(ref, frames, kept)
