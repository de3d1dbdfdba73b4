"""The dataset-driven loops (counterpart of `veon_tpu/train/loop.py`): the
stage-2 epoch loop with its per-epoch checkpoints, Occ3D evaluation and
the depth-cache writer, with the host-to-device boundary they share.

Batches cross to the device as JAX's `jnp.asarray` takes them with 64-bit
mode off: float64 becomes float32 and int64 int32, so the geometry never
runs in float64. On the card a batch is copied through pinned memory with
`non_blocking=True`; `pipeline=N` keeps N frames in flight, the next
frame enqueued before the oldest frame's grid is read back, and drains in
order.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ckpt.io import save_checkpoint
from .distributed import barrier

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}


def _to_device(tree, device, pinned: Optional[List[torch.Tensor]] = None):
    """`tree` (nested dicts, lists and tuples) with its numpy arrays as
    tensors on `device`, 64-bit types narrowed to 32 bits; anything else
    is left as it is. On the card each array is staged in pinned memory and
    copied asynchronously; the pinned tensors are appended to `pinned` for
    the caller to keep until the copies are done."""
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device, pinned) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device, pinned) for v in tree)
    if not isinstance(tree, np.ndarray):
        return tree
    a = np.ascontiguousarray(tree, _NARROW.get(tree.dtype, tree.dtype))
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    t = t.pin_memory()
    if pinned is not None:
        pinned.append(t)
    return t.to(device, non_blocking=True)


def prefetch_to_device(batches, device, size: int = 2):
    """Host-to-device double buffering: `size` batches already on their way
    to the device ahead of the consumer, so the next batch's copy overlaps
    the current step."""
    queue = collections.deque()
    for b in batches:
        queue.append(_to_device(b, device))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def _truncate_temporal(batch):
    """The current frame only, with `prev_lidarego2global` set to the
    identity: the epochs before the previous frames engage (the reference's
    SequentialControlHook)."""
    out = dict(batch)
    for k in ("imgs", "depth_imgs", "depth_preds"):
        if k in out:
            out[k] = out[k][:, :1]
    metas = dict(out["metas"])
    for k in ("sensor2egos", "ego2globals", "intrins", "post_rots", "post_trans"):
        metas[k] = metas[k][:, :1]
    metas["prev_lidarego2global"] = (metas["prev_lidarego2global"][:, :1] * 0
                                     + np.eye(4, dtype=np.float32))
    out["metas"] = metas
    return out


def train_epochs(state, step_fn, loader, ov_weight, max_epochs: int = 24, start_epoch: int = 0,
                 work_dir: str = "work_dir", log_interval: int = 50,
                 temporal_start_epoch: int = 0, log_fn: Callable[[str], None] = print,
                 writer=None, save: bool = True):
    """The stage-2 epoch loop: per epoch, `loader.set_epoch`, each batch
    without token / gt_depth / mask_lidar, truncated to the current frame
    before `temporal_start_epoch`, with `ov_weight` and the epoch (which the
    loss's priority-ignorance schedule reads), double-buffered onto the
    model's device and stepped; every `log_interval` iterations a log line
    (and `writer`, a `utils/logging.py` MetricWriter, gets the scalars and
    sec_per_iter); after each epoch a checkpoint with `next_epoch` where
    `save` (the other ranks of a process group pass False and wait at a
    barrier while it is written). Returns the state."""
    if save:
        os.makedirs(work_dir, exist_ok=True)
    device = next(state.model.parameters()).device
    for epoch in range(start_epoch, max_epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()

        def prepped():
            for batch in loader:
                for k in ("token", "gt_depth", "mask_lidar"):
                    batch.pop(k, None)
                if epoch < temporal_start_epoch:
                    batch = _truncate_temporal(batch)
                yield batch

        for it, batch in enumerate(prefetch_to_device(prepped(), device, size=2)):
            batch["ov_weight"], batch["epoch"] = ov_weight, epoch
            state, losses = step_fn(state, batch)
            if (it + 1) % log_interval == 0:
                dt = (time.perf_counter() - t0) / (it + 1)
                scalars = {k: float(v) for k, v in losses.items()}
                msg = ", ".join(f"{k}: {v:.4f}" for k, v in sorted(scalars.items()))
                log_fn(f"epoch {epoch + 1} iter {it + 1}/{len(loader)} ({dt:.2f}s/iter) {msg}")
                if writer is not None:
                    writer.write(dict(scalars, sec_per_iter=dt), state.step, epoch)
        if save:
            save_checkpoint(work_dir, state.step, state, next_epoch=epoch + 1)
        barrier()
        log_fn(f"saved checkpoint for epoch {epoch + 1}")
    return state


def _start_readback(x: torch.Tensor):
    """(host tensor, event): an asynchronous copy of `x` into pinned memory
    on the card (the event marks its end), `x` itself on the CPU."""
    if x.device.type != "cuda":
        return x, None
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _finish_readback(pending) -> np.ndarray:
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return host.numpy()


def evaluate_occ(predict_fn, loader, ov_weight, log_fn: Callable[[str], None] = print,
                 pipeline: int = 1, device="cuda"):
    """The Occ3D eval loop: per batch, `predict_fn(imgs, depth_imgs or
    depth_preds, metas, ov_weight)` gives the (B, X, Y, Z) class grids on
    `device`; their uint8 copies go to `loader.dataset.evaluate` in loader
    order. `pipeline` is the number of predictions in flight (1: strictly
    upload, forward, readback per frame; 2: frame N+1 is uploaded and
    enqueued before frame N's grid is read)."""
    depth = max(1, int(pipeline))
    results = []
    inflight = collections.deque()  # (pending readback, pinned inputs)

    def drain_one():
        pending, _pinned = inflight.popleft()
        pred = _finish_readback(pending)
        results.extend(list(pred))
        return pred.shape[0]

    t0 = time.perf_counter()
    n = 0
    for batch in loader:
        batch.pop("token", None)
        pinned: List[torch.Tensor] = []
        pred = predict_fn(_to_device(batch["imgs"], device, pinned),
                          _to_device(batch.get("depth_imgs", batch.get("depth_preds")), device,
                                     pinned),
                          _to_device(batch["metas"], device, pinned), ov_weight)
        inflight.append((_start_readback(pred.to(torch.uint8)), pinned))
        if len(inflight) >= depth:
            n += drain_one()
    while inflight:
        n += drain_one()
    dt = time.perf_counter() - t0
    log_fn(f"inference done: {n} samples in {dt:.3f}s ({n / max(dt, 1e-9):.3f} fps)")
    return loader.dataset.evaluate(results)


def write_depth_cache(depth_fn, loader, cache_dir: str, cam_names,
                      log_fn: Callable[[str], None] = print, pipeline: int = 1, device="cuda"):
    """One pass over the loader saving each camera's metric depth,
    `depth_fn(depth_imgs)` (B, F, N, h, w) of frame 0, as
    `cache_dir/token[:2]/token/token-CAM.npy`; files that exist are kept
    (idempotent). `pipeline` keeps that many batches in flight, as in
    `evaluate_occ`. Returns the number of files written."""
    os.makedirs(cache_dir, exist_ok=True)
    n_saved = 0
    inflight = collections.deque()

    def batches():
        for batch in loader:
            pinned: List[torch.Tensor] = []
            d = depth_fn(_to_device(batch["depth_imgs"], device, pinned))
            inflight.append((batch["token"], _start_readback(d), pinned))
            if len(inflight) >= max(1, pipeline):
                yield inflight.popleft()
        while inflight:
            yield inflight.popleft()

    for tokens, pending, _pinned in batches():
        depth = _finish_readback(pending)
        for bi, token in enumerate(tokens):
            d = os.path.join(cache_dir, token[:2], token)
            os.makedirs(d, exist_ok=True)
            for ci, cam in enumerate(cam_names):
                path = os.path.join(d, f"{token}-{cam}.npy")
                if os.path.exists(path):
                    continue
                np.save(path, depth[bi, 0, ci])
                n_saved += 1
    log_fn(f"depth cache: wrote {n_saved} tensors to {cache_dir}")
    return n_saved
