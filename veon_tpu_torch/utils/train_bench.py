"""Stage-2 training-step benchmark per recompute policy (counterpart of
`veon_tpu/utils/train_bench.py`), at production shapes (B=1, bf16, the
cached-depth regime of the reference's `withdepthcache` configs: metric
depth comes with the batch and the frozen tower is skipped):

  * ms/step per policy (full / dots_saveable /
    dots_with_no_batch_dims_saveable / none, `nn/rematutil.py`), in one
    process, each after an untimed first step;
  * the peak device memory of each policy's steps
    (`torch.cuda.max_memory_allocated`);
  * the forward and loss alone, splitting the step into forward against
    backward and optimizer;
  * a projected 24-epoch stage-2 wall-clock at the reference recipe's 8
    replicas (`README.md:153-236`: 24 epochs on 8 cards at B=1 each; the
    nuScenes train split's 28,130 samples -> 3,517 steps an epoch).

JAX reads a policy's memory from its compiled step without running it
(`--compile-only-policies`); eager PyTorch has no compile-time memory
analysis, so here such a policy takes one untimed step and reports its
peak device memory.

    python -m veon_tpu_torch.utils.train_bench --steps 6 \\
        --policies true,dots_saveable,dots_with_no_batch_dims_saveable
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .. import resolve_device
from ..nn.rematutil import RematSpec, parse_policy

NUSC_TRAIN_SAMPLES = 28130  # nuScenes train split (create_infos count)
RECIPE_EPOCHS = 24          # stage-2 recipe, configs/veon/...py:252
RECIPE_REPLICAS = 8         # dist_train.sh on 8 cards, README.md:157


def build_train_setup(preset: str = "veon_b", dtype: str = "bfloat16", device="cuda",
                      variables: Optional[Mapping] = None):
    """(cfg, batch, weights, membership) shared by every policy: the
    preset in `dtype` with LoRA folded, the cached-depth batch (the example
    rig, images and metric depth, the open-vocabulary matrix and random
    labels from default_rng(7), every voxel visible, epoch 0) on `device`,
    and the model's weights once (from `variables`, a JAX variables tree,
    else seeded) as a state dict on the CPU, loaded afresh per policy."""
    from ..cli.shapes import example_batch
    from ..configs import presets
    from ..entry import build_model
    from ..nn import text as text_mod

    dev = resolve_device(device)
    cfg = getattr(presets, preset)()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype,
                              depth=dataclasses.replace(cfg.depth, use_lora=False))
    imgs, depth, metas = example_batch(cfg, B=1, device=dev)
    prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    rng = np.random.default_rng(7)
    ovw = rng.standard_normal((len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)
    nx, ny, nz = cfg.grid.size
    batch = {"imgs": imgs, "depth": depth, "metas": metas,
             "voxel_semantics": torch.from_numpy(
                 rng.integers(0, 18, size=(1, nx, ny, nz)).astype(np.int32)).to(dev),
             "mask_camera": torch.ones(1, nx, ny, nz, dtype=torch.int32, device=dev),
             "ov_weight": torch.from_numpy(ovw).to(dev), "epoch": 0}
    model = build_model(cfg, dev, 0, variables)
    weights = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model
    return cfg, batch, weights, text_mod.merge_matrix(refl)


def _model(cfg, weights: Mapping[str, torch.Tensor], dev, remat: RematSpec):
    from ..entry import _no_tf32
    from ..model.veon import VeonModel

    _no_tf32(dev)
    model = VeonModel(cfg, device=dev, remat=remat)
    model.load_state_dict(weights)
    return model


def _memory(dev) -> Dict:
    if dev.type != "cuda":
        return {"error": "peak device memory is read on the card only"}
    return {"peak_gb": round(torch.cuda.max_memory_allocated(dev) / 2**30, 3)}


def measure_policy(cfg, batch, weights, membership, remat: RematSpec, steps: int = 6,
                   run: bool = True) -> Dict:
    """One train step untimed, then `steps` timed ones (host clock around
    each step, ended by reading its loss) under one recompute policy:
    ms/step (median) and spread, the peak device memory, and the 24-epoch
    projection. run=False: the untimed step and the memory only."""
    from ..train.step import AdamW, create_train_state, make_train_step

    dev = batch["imgs"].device
    out = {"remat": str(remat)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        model = _model(cfg, weights, dev, remat)
        tx = AdamW()
        state = create_train_state(model, tx)
        step = make_train_step(model, tx, cfg, membership)
        t0 = time.perf_counter()
        state, losses = step(state, batch)
        first = float(losses["loss_total"])
    except Exception as e:  # a policy that does not fit is a row of the report
        out["run_error"] = f"{type(e).__name__}: {str(e)[:300]}"
        return out
    out["first_step_s"] = round(time.perf_counter() - t0, 3)
    if not np.isfinite(first):
        raise FloatingPointError(f"loss {first} under remat {remat}")
    if not run:
        out["memory"] = _memory(dev)
        return out
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, losses = step(state, batch)
        total = float(losses["loss_total"])
        times.append(time.perf_counter() - t0)
        if not np.isfinite(total):
            raise FloatingPointError(f"loss {total} under remat {remat}")
    out["memory"] = _memory(dev)
    times.sort()
    med = times[len(times) // 2]
    out.update(ms_per_step=round(med * 1e3, 1),
               ms_spread=[round(times[0] * 1e3, 1), round(times[-1] * 1e3, 1)], steps=steps)
    # 8 data-parallel replicas at B=1 take 8 samples a step: 3,517 steps an
    # epoch; the all-reduce across cards is not in this one-card time
    steps_total = -(-NUSC_TRAIN_SAMPLES // RECIPE_REPLICAS) * RECIPE_EPOCHS
    out["projected_24ep_8chip_h"] = round(steps_total * med / 3600.0, 1)
    return out


def measure_forward_loss(cfg, batch, weights, membership, steps: int = 6) -> Dict:
    """The train-mode forward and loss alone, no gradient or optimizer:
    the forward's share of the step (the first call untimed)."""
    from ..train.step import loss_fn

    dev = batch["imgs"].device
    model = _model(cfg, weights, dev, False)  # recompute is a backward knob

    def once():
        with torch.no_grad():
            return float(sum(loss_fn(model, cfg, membership, batch).values()))

    t0 = time.perf_counter()
    first = once()
    first_s = time.perf_counter() - t0
    if not np.isfinite(first):
        raise FloatingPointError(f"forward loss {first}")
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    return {"ms_forward_loss": round(med * 1e3, 1), "first_call_s": round(first_s, 3)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="veon_b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--policies", default="true,dots_saveable,dots_with_no_batch_dims_saveable")
    ap.add_argument("--compile-only-policies", default="false",
                    help="policies that take one untimed step for their peak memory only")
    ap.add_argument("--skip-forward", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = ap.parse_args(argv)

    cfg, batch, weights, membership = build_train_setup(args.preset, args.dtype, args.device)
    rows = []
    if not args.skip_forward:
        fwd = measure_forward_loss(cfg, batch, weights, membership, args.steps)
        print(json.dumps({"leg": "forward_loss", **fwd}), flush=True)
        rows.append(fwd)
    for tok in filter(None, args.policies.split(",")):
        r = measure_policy(cfg, batch, weights, membership, parse_policy(tok), args.steps)
        print(json.dumps({"leg": "train_step", **r}), flush=True)
        rows.append(r)
    for tok in filter(None, args.compile_only_policies.split(",")):
        r = measure_policy(cfg, batch, weights, membership, parse_policy(tok), args.steps,
                           run=False)
        print(json.dumps({"leg": "train_step_compile_only", **r}), flush=True)
        rows.append(r)
    return rows


if __name__ == "__main__":
    main()
