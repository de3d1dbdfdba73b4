"""Command line of the port (counterpart of `veon_tpu/cli/main.py`): the
`serve`, `selftest`, `train` (stage 2), `pretrain-depth` (stage 1),
`publish`, `test` (Occ3D mIoU of the model or of training checkpoints, or
POP-3D retrieval AP with --retrieval), `cache-depth`, `create-infos`,
`benchmark` (the live F=1 graph, the streaming step, an exported program,
or with --eval the `test` loop), `export` (the serving graph as a
`torch.export` `.pt2` program, or with --native an AOTInductor bundle for
the C++ daemon), `parity` (weights day: a reference dump
replayed boundary by boundary) and `vis` (occupancy images, point cloud,
semantic overlays) subcommands. `text_classifier`, the counterpart of the reference's
`_text_classifier`, lives in `nn/text.py` and is re-exported here.

    python -m veon_tpu_torch.cli.main serve --preset veon_b \
        --socket /tmp/veon.sock [--num-temporal 2] [--raw-uint8] \
        [--load-from SAN_ViT-B.pth --depth-load-from depth.pth] \
        [--bpe-path bpe_simple_vocab_16e6.txt.gz]
    python -m veon_tpu_torch.cli.main selftest [--weights-dir ckpts/]
    python -m veon_tpu_torch.cli.main pretrain-depth --preset veon_b \
        --ann data/nuscenes/bevdetv2-nuscenes_infos_train.pkl --work-dir w1 \
        [--depth-load-from depth_anything_v2_metric_vkitti_vitl.pth]
    python -m veon_tpu_torch.cli.main train --preset veon_b --work-dir w2 \
        [--load-from SAN.pth --depth-load-from depth.pth] [--auto-resume] \
        [--accum-steps 2] [--depth-cache data/nuscenes/depth_cache/...] \
        [--num-temporal 2 --temporal-start-epoch 1] [--remat none|full|dots_saveable] \
        [--dist-coordinator host:port --dist-num-processes 2 --dist-process-id 0]
    python -m veon_tpu_torch.cli.main publish --ckpt w2/step_N \
        --out-prefix veon_b_epoch24 [--ema]
    python -m veon_tpu_torch.cli.main test --data-root data/nuscenes \
        --ann data/nuscenes/bevdetv2-nuscenes_infos_val.pkl \
        [--ckpt w2/step_N [--ema] | --all-ckpts --work-dir w2 \
         [--sweep-from N] [--sweep-to M]] \
        [--pipeline 2] [--raw-uint8] [--fuse-conv-bn] [--num-temporal 2] \
        [--retrieval --retrieval-items retrieval_anns_val.csv]
    python -m veon_tpu_torch.cli.main cache-depth --ann ... --cache-dir ...
    python -m veon_tpu_torch.cli.main create-infos --data-root data/nuscenes \
        [--version v1.0-trainval] [--val-scenes val.txt] [--out-prefix ...]
    python -m veon_tpu_torch.cli.main benchmark --eval [--frames 12]
    python -m veon_tpu_torch.cli.main benchmark [--preset veon_l] \
        [--num-temporal 2 | --artifact work_dir/veon_infer.pt2]
    python -m veon_tpu_torch.cli.main export --work-dir work_dir \
        [--num-temporal 2 [--raw-uint8]] [--native [--split-output 2]]
    python -m veon_tpu_torch.cli.main parity --dumps dump_dir \
        [--weights-dir ckpts/ | --load-from SAN.pth --depth-load-from depth.pth]
    python -m veon_tpu_torch.cli.main vis --work-dir vis_out \
        [--ann data/nuscenes/bevdetv2-nuscenes_infos_val.pkl --data-root data/nuscenes]

Every command that runs the model runs on the card unless --device cpu.

The server answers `serve/client.py` `TensorClient` (and the JAX
package's python and C++ clients): F=1 requests carry imgs and
depth_imgs, streaming requests (--num-temporal > 1) one frame each plus
lidarego2global; either may add text_embed (C,) or text_tokens (1, 77)
int32 for a free-text `retrieval` map. The CLI computes in the preset's
dtype (fp32 for every preset, as the reference's CLI); `benchmark` in bf16
unless VEON_ENTRY_DTYPE names another; `export` the F=1 graph in bf16 (the
flagship's) and the streaming step in the preset's dtype. A `.pt2` holds
its weights and runs on the device it was exported on; it loads where
`veon_tpu_torch` imports, since kernels #1-#3 and the stencil are its registered
operators (`utils/export.py` `load_inference`; `serve/server.py`
`serve_exported` serves one). Weights come from the
reference's PyTorch checkpoints (`--load-from`, `--depth-load-from`,
converted by `ckpt/convert.py`, LoRA folded in), else seeded stand-ins;
`entry.serve_entry` also takes JAX variables and text-tower params.
Training writes `<work-dir>/step_<n>/` checkpoints (`ckpt/io.py`); `test
--ckpt` loads one over the model, strict on both sides. `train` runs
data-parallel with one process per card (`train/distributed.py`: the
--dist-* options, or torchrun's variables); rank 0 alone writes the work
dir; --remat recomputes the scan-stacked blocks in the backward (full, the
default, as the reference's `torch.utils.checkpoint`), none, or saves what
a named policy says (`nn/rematutil.py`). `parity` exits 1 on a failed
boundary. `export --native` writes the bundle that the C++ daemon
`veon_serve_host` and runner `veon_aoti_runner` serve with no Python
(`ops/native.py` `build_host` builds them; `utils/export.py`).

--cam-shards S shards the six cameras over S processes
(`serve/camshard.py`), started as the data-parallel ones are (torchrun, or
--dist-* per process), one card per rank over NCCL:

    torchrun --nproc-per-node 3 -m veon_tpu_torch.cli.main serve \
        --preset veon_b --cam-shards 3 --socket /tmp/veon.sock
    python -m veon_tpu_torch.cli.main train ... --cam-shards 2 \
        --dist-coordinator localhost:29500 --dist-num-processes 4 \
        --dist-process-id {0..3}

`serve` takes a world of exactly S processes: rank 0 owns the socket and
broadcasts each request, every rank computes. `train` lays the world out
as (world / S) batch rows x S cam ranks, each row loading its own shard
of the data. Ranks that share one card (a check, not a deployment: NCCL
refuses them and gloo sums through the host) open their group with
`train/distributed.py` `init_group(..., backend="gloo")` and build the
handler with `entry.serve_entry(cam_group=...)` or the step with
`train/step.py` `make_train_step(cam_group=...)`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from .. import resolve_device, torch_dtype
from ..ckpt import convert as C
from ..ckpt.from_jax import load_families, load_from_jax, variables_from_model
from ..ckpt.io import (checkpoint_next_epoch, find_latest, list_checkpoints, load_checkpoint,
                       publish_checkpoint, save_checkpoint)
from ..cli.shapes import example_batch, example_batch_full
from ..collectives import cam_groups, data_parallel
from ..configs import presets
from ..data.create_infos import create_infos
from ..data.loader import DataLoader
from ..data.nuscenes import (NuScenesOccDataset, NuScenesRetrievalDataset, load_infos,
                             load_retrieval_csv)
from ..data.transforms import normalize_in_graph
from ..entry import _no_tf32, build_model, serve_entry, serving_model
from ..eval.miou import MIoUMetric
from ..eval.retrieval import retrieval_scores
from ..model.veon import fused_classes
from ..nn import text as text_mod
from ..nn.dpt import DepthAnythingV2
from ..nn.layers import init_random_
from ..nn.rematutil import check_policy, parse_policy
from ..nn.text import text_classifier  # noqa: F401  (the CLI's `_text_classifier`)
from ..nn.zoedepth import ZoeDepthNK
from ..model.camshard import prepare_camshard_metas
from ..serve.server import TensorServer
from ..train.depth_pretrain import depth_trainable, make_depth_pretrain_step, zoe_trainable
from ..train.loop import _to_device, evaluate_occ, train_epochs, write_depth_cache
from ..train.distributed import broadcast_state, initialize as dist_init, process_shard
from ..train.distributed import shutdown as dist_shutdown
from ..train.step import AdamW, create_train_state, make_train_step, stage2_trainable
from ..utils import bench_model
from ..utils.export import (_build_streaming, export_flagship, export_flagship_native,
                            export_streaming, export_streaming_native, export_tiny_native,
                            load_program)
from ..utils.logging import MetricWriter
from ..utils.params import param_table


def build_cfg(args):
    """The preset named by args with its frame count, in the preset's own
    compute dtype (fp32 for every preset, as the reference's CLI), with
    `data.raw_uint8` set by --raw-uint8."""
    cfg = getattr(presets, args.preset)(num_temporal=getattr(args, "num_temporal", 1))
    if getattr(args, "raw_uint8", False):
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, raw_uint8=True))
    return cfg


def load_checkpoints(cfg, san_ckpt=None, depth_ckpt=None):
    """(variables, extras) from the reference's checkpoints: the converted
    families of a SAN/VEON semantic dump (clip_visual, rec_head,
    side_adapter, hsa, alignnet with its batch_stats, lift_fusion) and of a
    depth dump in the preset's branch (depth: a DA-V2 dump, its LoRA
    adapters folded in with scale lora_alpha / r, or for a zoe preset a
    ZoeDepth-NK dump, folded with scale 1 / r, the adapters' alpha 1);
    variables None without either file. extras holds the semantic dump's
    text tower, bg_embed and logit_scale where it has them."""
    params, stats, extras = {}, {}, {}
    if san_ckpt:
        params, stats, extras = C.convert_san_semantic(C.load_torch_state_dict(san_ckpt), cfg)
    if depth_ckpt:
        sd = C.load_torch_state_dict(depth_ckpt)
        if cfg.depth_mode == "zoedepth":
            depth = C.merge_lora(C.convert_zoedepth(sd, cfg.zoe), 1.0)
        else:
            depth = C.merge_lora(C.convert_dav2(sd, cfg.depth), cfg.depth.lora_alpha)
        params = dict(params, depth=depth)
    return ({"params": params, "batch_stats": stats} if params else None), extras


def checkpoint_model(cfg, variables, device="cuda", seed: int = 0, remat=False):
    """The model on `device` as the reference's CLI builds it from its
    checkpoints: a seeded init with each converted family of `variables`
    (`load_checkpoints`) loaded over it, strict on both sides within the
    family (`from_jax.load_families`, the counterpart of merging the
    converted families into the init tree); seeded alone without
    variables. Only this route fills a partial tree: the entry points load
    a whole tree strictly."""
    model = build_model(cfg, resolve_device(device), seed, None, remat)
    if variables is not None:
        load_families(model, variables)
    return model


def build_model_and_params(cfg, san_ckpt=None, depth_ckpt=None, bpe_path=None, device="cuda",
                           seed: int = 0, train: bool = False, remat_policy=None):
    """(model, text tower, open-vocabulary weight, merge matrix, extras)
    (counterpart of `_build_model_and_params`): the checkpoints converted
    and loaded family by family (`checkpoint_model`), the rest seeded; the
    classifier from the checkpoint's text tower, bg_embed and logit_scale,
    with the reference's refusals (no BPE merges, another vocabulary size),
    else the placeholder N(0, 1) of default_rng(0). A training build
    recomputes its blocks in the backward (`remat_policy`: True, False or
    a policy name; None is True); an eval build never does."""
    remat = remat_policy if (train and remat_policy is not None) else train
    variables, extras = load_checkpoints(cfg, san_ckpt, depth_ckpt)
    model, tower, ovw, membership = serving_model(
        cfg, device, seed, None, extras.get("text_tower"), extras.get("bg_embed"),
        extras.get("logit_scale"), bpe_path,
        checkpoint_model(cfg, variables, device, seed, remat))
    return model, tower, ovw, membership, extras


def build_serve_handler(args, cam_group=None):
    """(handler, required request keys, expectation string, exclusive) for
    `cmd_serve`, built by `entry.serve_entry` on `checkpoint_model`; split
    out so tests and `chip_smoke.py` mount the handler on their own
    `TensorServer`. --cam-shards S takes the open process group's S ranks
    (a world of any other size raises JAX's error before anything is
    built), unless `cam_group` names the ranks; every rank builds its
    handler (`entry.ServeHandler`: the first rank serves, the others
    follow)."""
    shards = getattr(args, "cam_shards", 1)
    if cam_group is None:
        world = dist.get_world_size() if data_parallel() else 1
        if world != shards:
            raise ValueError(f"--cam-shards {shards} needs that many devices; have {world}")
        if shards > 1:
            cam_group = cam_groups(1, shards)
    cfg = build_cfg(args)
    variables, extras = load_checkpoints(cfg, args.load_from, args.depth_load_from)
    return serve_entry(cfg, device=args.device, model=checkpoint_model(cfg, variables, args.device),
                       text_tower=extras.get("text_tower"), bg_embed=extras.get("bg_embed"),
                       logit_scale=extras.get("logit_scale"), bpe_path=args.bpe_path,
                       raw_uint8=args.raw_uint8, cam_group=cam_group)


def cmd_serve(args):
    """Bind the model, rig precompute and classifier on the device and
    answer requests over a unix socket until interrupted. With --cam-shards
    S the S processes of the group (--dist-* or torchrun's variables) each
    build the sharded handler; rank 0 serves the socket, the others compute
    the requests it broadcasts."""
    opened = dist_init(args.dist_coordinator, args.dist_num_processes, args.dist_process_id,
                       device=args.device)
    try:
        handler, required, expect, exclusive = build_serve_handler(args)
        if not handler.leader:
            handler.follow()
            return
        srv = TensorServer(handler, args.socket, required=required, exclusive=exclusive)
        srv.start()
        print(f"serving on {args.socket} ({expect}); ctrl-c to stop", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
            handler.close()
    finally:
        if opened:
            dist_shutdown()


def resolve_weights_dir(weights_dir: str, preset: str):
    """{"san", "depth"[, "bpe"]: path} in the reference README's checkpoint
    layout under weights_dir (counterpart of `_resolve_weights_dir`):

      clipsan/SAN_ViT-B.pth | SAN_ViT-L.pth   (or raw san_vit_b_16.pth /
                                               san_vit_large_14.pth)
      depth_pretrain/depthanythingv2_pretrain_large.pth  (finetuned; or the
        published depthanythingv2/depth_anything_v2_metric_vkitti_vitl.pth)
      depth_pretrain/zoedepth_pretrain.pth               (zoe presets)
      bpe_simple_vocab_16e6.txt.gz                       (CLIP tokenizer)

    A missing checkpoint raises FileNotFoundError naming each."""
    large, zoe = "_l" in preset, "zoe" in preset
    found, missing = {}, []

    def pick(key, candidates, required=True):
        for c in candidates:
            p = os.path.join(weights_dir, c)
            if os.path.isfile(p):
                found[key] = p
                return
        if required:
            missing.append(f"{key}: expected one of {candidates}")

    pick("san", ["clipsan/SAN_ViT-L.pth", "clipsan/san_vit_large_14.pth"]
         if large else ["clipsan/SAN_ViT-B.pth", "clipsan/san_vit_b_16.pth"])
    pick("depth", ["depth_pretrain/zoedepth_pretrain.pth"] if zoe else
         ["depth_pretrain/depthanythingv2_pretrain_large.pth",
          "depthanythingv2/depth_anything_v2_metric_vkitti_vitl.pth"])
    pick("bpe", ["bpe_simple_vocab_16e6.txt.gz", "clipsan/bpe_simple_vocab_16e6.txt.gz"],
         required=False)
    if missing:
        raise FileNotFoundError(
            "weights-dir is missing required checkpoints (see the reference "
            "README.md:118-131 for the layout):\n  " + "\n  ".join(missing))
    return found


def cmd_selftest(args):
    """Synthetic end-to-end smoke at the tiny preset on the device (seeded
    weights, the lift without a presorted rig), or with --weights-dir the
    weights-arrival drill (`selftest_weights`)."""
    if args.weights_dir:
        return selftest_weights(args)
    cfg = presets.veon_tiny_test()
    dev = resolve_device(args.device)
    model = build_model(cfg, dev, 0, None)
    imgs, depth, metas = example_batch(cfg, device=dev)
    prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    ovw = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32)).to(dev)
    with torch.no_grad():
        out = model(imgs, depth, metas, ovw)
    pred = fused_classes(out, text_mod.merge_matrix(refl))
    print("selftest ok:", {k: tuple(v.shape) for k, v in sorted(out.items())},
          "pred", tuple(pred.shape))


def selftest_weights(args):
    """The five-step weights-arrival drill (counterpart of
    `_selftest_weights`): 1. resolve the README layout, 2. convert every
    dialect, 3. load into the preset (every converted family strict on both
    sides), 4. one full forward on the example rig without a presorted lift
    (the banded lift, kernel #3 on the card), 5. fusion-rule classes and
    their mIoU against seeded labels. Returns {"miou": ...}."""
    cfg = build_cfg(args)
    paths = resolve_weights_dir(args.weights_dir, args.preset)
    print(f"[1/5] resolved weights: { {k: v for k, v in paths.items()} }")
    model, _tower, ovw, membership, extras = build_model_and_params(
        cfg, paths["san"], paths["depth"], args.bpe_path or paths.get("bpe"),
        device=args.device)
    if "text_tower" not in extras:
        print("WARNING: checkpoint carried no ov_classifier text tower — "
              "the classifier stays random; mIoU below is structural only")
    print("[2/5] converted + [3/5] loaded into", args.preset)
    imgs, depth_imgs, metas = example_batch_full(cfg, device=ovw.device)
    with torch.no_grad():
        out = model.full_forward(imgs, depth_imgs, metas, ovw)
    print("[4/5] full forward ok:", {k: tuple(v.shape) for k, v in sorted(out.items())})
    pred = fused_classes(out, membership).cpu().numpy()
    gt = np.random.default_rng(0).integers(0, 18, size=pred.shape).astype(np.int32)
    metric = MIoUMetric()
    metric.add_batch(pred, gt, mask_camera=np.ones_like(gt, bool))
    _, _, miou = metric.count_miou()
    print(f"[5/5] tiny-fixture mIoU vs synthetic GT: {miou:.2f} "
          "(structural check — run `test --ann <val infos>` for the real "
          "Occ3D number)")
    return {"miou": miou}


def fuse_model_conv_bn(model) -> None:
    """Fold every BatchNorm into the convolution before it, in place
    (`tools/test.py --fuse-conv-bn`): the model's JAX variables tree
    through `ckpt/convert.py` `fuse_conv_bn` and back."""
    v = variables_from_model(model)
    params, stats = C.fuse_conv_bn(v["params"], v.get("batch_stats", {}))
    load_from_jax(model, {"params": params, "batch_stats": stats})


def occ_predictor(model, membership, depth_norm_method: str, raw_uint8: bool = False):
    """predict(imgs, depth_imgs or depth_preds, metas, ov_weight) -> the
    (B, X, Y, Z) int32 class grids of `model` (the full forward, the
    vocabulary merge and the fusion rule); with raw_uint8 the uint8 frames
    are normalized on the device first (cached metric depth stays as it is)."""

    @torch.no_grad()
    def predict(imgs, depth_imgs, metas, ov_weight):
        if raw_uint8:
            imgs = normalize_in_graph(imgs, "clipsan")
            if depth_imgs.dtype == torch.uint8:
                depth_imgs = normalize_in_graph(depth_imgs, depth_norm_method)
        return fused_classes(model.full_forward(imgs, depth_imgs, metas, ov_weight), membership)

    return predict


def ckpt_eval_variables(state, ema: bool, path: str = ""):
    """{"params", "batch_stats"} of a loaded checkpoint tree, or its EMA
    shadow with `ema` (counterpart of `_ckpt_eval_variables`); --ema on a
    published (stripped) checkpoint exits with the reason, for one --ckpt
    and for each checkpoint of an --all-ckpts sweep alike."""
    if ema and "ema_params" not in state:
        raise SystemExit(
            f"--ema with a published checkpoint{f' ({path})' if path else ''}: the EMA shadow "
            "was either already published as params (publish --ema) or stripped - drop the "
            "--ema flag")
    return {"params": state["ema_params" if ema else "params"],
            "batch_stats": state["ema_batch_stats" if ema else "batch_stats"]}


def cmd_test(args):
    """Occ3D evaluation (counterpart of `cmd_test`): the val infos through
    the dataset and loader, one fusion-rule class grid per sample, the
    camera-masked mIoU; --ckpt evaluates a training checkpoint (its EMA
    shadow with --ema), --all-ckpts every step_<n> under --work-dir within
    --sweep-from / --sweep-to; with --retrieval the POP-3D evaluation
    instead. Prints and returns the metrics ({"sweep": {n: metrics}} for a
    sweep)."""
    if args.retrieval:
        return cmd_test_retrieval(args)
    cfg = build_cfg(args)
    model, _tower, ovw, membership, _extras = build_model_and_params(
        cfg, args.load_from, args.depth_load_from, args.bpe_path, device=args.device)
    if args.ckpt:
        load_from_jax(model, ckpt_eval_variables(load_checkpoint(args.ckpt), args.ema, args.ckpt))
    if args.fuse_conv_bn:
        fuse_model_conv_bn(model)
    ds = NuScenesOccDataset(
        infos=load_infos(args.ann), data_cfg=cfg.data, grid=cfg.grid,
        num_temporal=cfg.num_temporal, is_train=False, data_root=args.data_root,
        load_lidar_depth=False, raw_uint8=cfg.data.raw_uint8)
    loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=args.workers,
                        drop_last=False)
    predict = occ_predictor(model, membership, cfg.data.depth_norm_method, cfg.data.raw_uint8)
    if args.all_ckpts:
        sweep = {}
        for step_n, path in list_checkpoints(args.work_dir, args.sweep_from, args.sweep_to):
            load_from_jax(model, ckpt_eval_variables(load_checkpoint(path), args.ema, path))
            if args.fuse_conv_bn:
                fuse_model_conv_bn(model)
            sweep[step_n] = evaluate_occ(predict, loader, ovw, pipeline=args.pipeline,
                                         device=ovw.device)
            print(f"step {step_n}: {json.dumps(sweep[step_n])}")
        print(json.dumps({"sweep": sweep}, indent=2))
        return {"sweep": sweep}
    res = evaluate_occ(predict, loader, ovw, pipeline=args.pipeline, device=ovw.device)
    print(json.dumps(res, indent=2))
    return res


def cmd_test_retrieval(args):
    """POP-3D free-text retrieval (counterpart of `cmd_test_retrieval`): per
    item of --retrieval-items (the published `retrieval_anns_{split}.csv`,
    or a JSON list of {token, prompt, anno_file, points_file}), the cosine
    of the voxel CLIP features against the prompt's text embedding, scored
    as AP over the annotated points and their camera-visible subset. The
    text tower is the checkpoint's, else seeded."""
    cfg = build_cfg(args)
    model, tower, ovw, _membership, _extras = build_model_and_params(
        cfg, args.load_from, args.depth_load_from, args.bpe_path, device=args.device)
    tok = text_mod.ClipTokenizer(args.bpe_path)
    if args.retrieval_items.endswith(".csv"):
        items = load_retrieval_csv(args.retrieval_items)
    else:
        with open(args.retrieval_items) as f:
            items = json.load(f)
    ds = NuScenesRetrievalDataset(
        infos=load_infos(args.ann), data_cfg=cfg.data, grid=cfg.grid,
        num_temporal=cfg.num_temporal, is_train=False, data_root=args.data_root,
        load_lidar_depth=False, load_occ_gt=False)
    ds.filter_to_retrieval(items)
    loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=args.workers,
                        drop_last=False)
    dev = ovw.device
    results = []
    with torch.no_grad():
        for batch in loader:
            prompt = batch["retrieval_prompt"][0]
            emb = tower(torch.from_numpy(tok.tokenize([prompt])).to(dev))[0]
            imgs, depth_imgs = _to_device(batch["imgs"], dev), _to_device(batch["depth_imgs"], dev)
            if cfg.data.raw_uint8:
                imgs = normalize_in_graph(imgs, "clipsan")
                depth_imgs = normalize_in_graph(depth_imgs, cfg.data.depth_norm_method)
            out = model.full_forward(imgs, depth_imgs, _to_device(batch["metas"], dev), ovw)
            # (B, Z, Y, X, C) -> (B, X, Y, Z, C), the GT's voxel indexing
            feat = out["feat_occ"].permute(0, 3, 2, 1, 4)
            r = retrieval_scores(feat[0].cpu().numpy(), emb.cpu().numpy(),
                                 batch["points_indices"][0], batch["matching_points"][0],
                                 batch["retrieval_anno"][0])
            print(prompt, r)
            results.append(r)
    summary = ds.evaluate_retrieval(results)
    print(json.dumps(summary, indent=2))
    return summary


def cmd_cache_depth(args):
    """Depth-cache generation (counterpart of `cmd_cache_depth`): every
    camera's metric depth from the depth tower, written per token and
    camera by `train/loop.py` `write_depth_cache`. Returns the files
    written."""
    cfg = build_cfg(args)
    model, _tower, ovw, _membership, _extras = build_model_and_params(
        cfg, depth_ckpt=args.depth_load_from, device=args.device)

    @torch.no_grad()
    def depth_fn(depth_imgs):
        if cfg.data.raw_uint8:
            depth_imgs = normalize_in_graph(depth_imgs, cfg.data.depth_norm_method)
        return model.estimate_depth(depth_imgs).float()

    ds = NuScenesOccDataset(
        infos=load_infos(args.ann), data_cfg=cfg.data, grid=cfg.grid, num_temporal=1,
        is_train=False, data_root=args.data_root, load_lidar_depth=False, load_occ_gt=False)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=False,
                        num_workers=args.workers, drop_last=False)
    return write_depth_cache(depth_fn, loader, args.cache_dir, cfg.data.cams, device=ovw.device)


def refuse_unported_training(args):
    """The `train` options that are not ported, refused before anything is
    built: a --remat that names no policy the port has (ValueError,
    `rematutil.check_policy`)."""
    check_policy(parse_policy(args.remat))


def cmd_train(args):
    """Stage-2 training (counterpart of `cmd_train`): the model from the
    reference's checkpoints or seeded, the train infos through the dataset
    (augmented, shuffled per epoch) and loader, AdamW over hsa /
    lift_fusion / alignnet with `--accum-steps` micro-steps per update, the
    EMA, a checkpoint per epoch in --work-dir with its NEXT_EPOCH marker,
    and with --auto-resume the latest of them restored and only the epochs
    after it run. With --num-temporal F the epochs from
    --temporal-start-epoch on train on F frames, those before it on the
    current frame. --remat picks what the backward recomputes. With
    --dist-* (or torchrun's variables) each process
    trains on its shard of the data on its own card, in lockstep
    (`train/distributed.py`); rank 0 prints the param table and writes the
    checkpoints and the log. With --cam-shards S the world is (world / S)
    batch rows x S cam ranks: each row loads its shard of the data, each
    rank runs its cameras of the row's batch (`model/camshard.py`), the
    batch's metas pinned to the whole rig's keyego anchor. Scalars go to
    <work-dir>/train.log.jsonl every 50 iterations. Returns
    {"start_epoch", "step"}."""
    refuse_unported_training(args)
    opened = dist_init(args.dist_coordinator, args.dist_num_processes, args.dist_process_id,
                       device=args.device)
    try:
        world = dist.get_world_size() if data_parallel() else 1
        if world % args.cam_shards:
            raise ValueError(f"{world} devices not divisible by --cam-shards {args.cam_shards}")
        return _train(args)
    finally:
        if opened:
            dist_shutdown()


def _train(args):
    rank, count = process_shard()
    cam_group = cam_groups(count // args.cam_shards, args.cam_shards) \
        if args.cam_shards > 1 else None
    # the data's shards: one per batch row, every cam rank of a row loads it
    shard, shards = (rank, count) if cam_group is None else (cam_group.batch_index,
                                                             cam_group.batch_shards)
    cfg = build_cfg(args)
    model, _tower, ovw, membership, _extras = build_model_and_params(
        cfg, args.load_from, args.depth_load_from, args.bpe_path, device=args.device,
        train=True, remat_policy=parse_policy(args.remat))
    broadcast_state(model)
    if rank == 0:
        print(param_table(model, stage2_trainable))
    ds = NuScenesOccDataset(
        infos=load_infos(args.ann), data_cfg=cfg.data, grid=cfg.grid,
        num_temporal=cfg.num_temporal, is_train=True, data_root=args.data_root,
        depth_cache_dir=args.depth_cache)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True, num_workers=args.workers,
                        shard=(shard, shards) if shards > 1 else None)
    tx = AdamW(lr=args.lr, accum_steps=args.accum_steps)
    state = create_train_state(model, tx)
    start_epoch = 0
    latest = find_latest(args.work_dir) if args.auto_resume else None
    if latest is not None:
        state = load_checkpoint(latest, target=state)
        broadcast_state(model)
        start_epoch = checkpoint_next_epoch(latest)
        if start_epoch is None:
            start_epoch = state.step // max(len(ds) // args.batch_size, 1)
            print(f"auto-resumed from {latest} (no NEXT_EPOCH marker; estimated epoch "
                  f"~{start_epoch})")
        else:
            print(f"auto-resumed from {latest} (epoch {start_epoch})")
    if cam_group is None:
        step = make_train_step(model, tx, cfg, membership)
    else:
        base_step = make_train_step(model.set_cam_group(cam_group), tx, cfg, membership,
                                    cam_group=cam_group)

        def step(state, batch):
            batch = dict(batch, metas=prepare_camshard_metas(cfg, batch["metas"],
                                                             args.cam_shards))
            return base_step(state, batch)
    log = MetricWriter(args.work_dir, tensorboard=True) if rank == 0 else contextlib.nullcontext()
    with log as writer:
        state = train_epochs(state, step, loader, ovw, max_epochs=args.epochs,
                             start_epoch=start_epoch, work_dir=args.work_dir,
                             temporal_start_epoch=args.temporal_start_epoch, writer=writer,
                             save=rank == 0)
    return {"start_epoch": start_epoch, "step": state.step}


def depth_tower(cfg, device="cuda", seed: int = 0):
    """(tower, trainable predicate, converter) of stage 1 for the preset's
    depth branch: DA-V2 or ZoeDepth-NK with its LoRA adapters, seeded, on
    `device`, in the preset's dtype."""
    dev = resolve_device(device)
    _no_tf32(dev)
    dt = torch_dtype(cfg.compute_dtype)
    with torch.device(dev):
        if cfg.depth_mode == "zoedepth":
            tower = ZoeDepthNK(cfg.zoe, dtype=dt, lora=True)
            trainable, convert = zoe_trainable, lambda sd: C.convert_zoedepth(sd, cfg.zoe)
        else:
            tower = DepthAnythingV2(cfg.depth, dtype=dt, lora=True)
            trainable, convert = depth_trainable, lambda sd: C.convert_dav2(sd, cfg.depth)
    init_random_(tower, torch.Generator(device=dev).manual_seed(seed))
    return tower, trainable, convert


def cmd_pretrain_depth(args):
    """Stage-1 depth pretraining (counterpart of `cmd_pretrain_depth`): the
    preset's depth tower with LoRA adapters fed the full input resolution
    (DA-V2 resizes it to its lower bound, zoe takes it as it is), a
    --depth-load-from dump converted and merged over the seeded tree (a
    published dump carries no adapters: stage 1 trains fresh ones), the
    adapters (and the DPT head, or zoe's decoder and bins head) trained
    against the dataset's LiDAR depth, a checkpoint after each epoch.
    Returns {"checkpoint", "losses"} (the last step's)."""
    cfg = build_cfg(args)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, depth_input_size=cfg.data.input_size))
    tower, trainable, convert = depth_tower(cfg, args.device)
    if args.depth_load_from:
        merged = C.merge_params(variables_from_model(tower)["params"],
                                convert(C.load_torch_state_dict(args.depth_load_from)))
        load_from_jax(tower, {"params": merged})
    tx = AdamW(lr=args.lr, accum_steps=args.accum_steps)
    state = create_train_state(tower, tx, init_updates=0, predicate=trainable)
    step = make_depth_pretrain_step(tower, tx, cfg.grid, cfg.loss, norm_in_graph=(
        cfg.data.depth_norm_method if cfg.data.raw_uint8 else None))
    ds = NuScenesOccDataset(
        infos=load_infos(args.ann), data_cfg=cfg.data, grid=cfg.grid, num_temporal=1,
        is_train=True, data_root=args.data_root, load_occ_gt=False)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True, num_workers=args.workers)
    dev = next(tower.parameters()).device
    path, losses = None, {}
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        for it, batch in enumerate(loader):
            b = {"depth_imgs": batch["depth_imgs"], "gt_depth": batch["gt_depth"]}
            state, losses = step(state, _to_device(b, dev))
            if (it + 1) % 50 == 0:
                print(f"epoch {epoch + 1} iter {it + 1}: "
                      + ", ".join(f"{k}={float(v):.4f}" for k, v in losses.items()))
        path = save_checkpoint(args.work_dir, state.step, state)
    return {"checkpoint": path, "losses": losses}


def cmd_publish(args):
    """Checkpoint publishing (counterpart of `cmd_publish`): a training
    checkpoint stripped to inference weights (the EMA shadow with --ema),
    its name stamped with the content hash. Returns the directory."""
    if not args.ckpt or not args.out_prefix:
        raise SystemExit("publish needs --ckpt <step dir> and --out-prefix <output path>")
    final = publish_checkpoint(args.ckpt, args.out_prefix, ema=args.ema)
    print("published:", final)
    return final


def cmd_create_infos(args):
    """Info generation (counterpart of `cmd_create_infos`): the raw nuScenes
    JSON tables under <data-root>/<version> into
    <out-prefix>_infos_{train,val}.pkl; scenes named by --val-scenes (a
    comma list, or a file with one name per line) go to val."""
    val = []
    if args.val_scenes:
        if os.path.exists(args.val_scenes):
            with open(args.val_scenes) as f:
                val = [ln.strip() for ln in f if ln.strip()]
        elif os.sep in args.val_scenes or args.val_scenes.endswith(".txt"):
            # a path, not a scene list: a mistyped file must not route
            # every scene to train
            raise SystemExit(f"--val-scenes file not found: {args.val_scenes}")
        else:
            val = [s for s in args.val_scenes.split(",") if s]
    prefix = args.out_prefix or os.path.join(args.data_root, "bevdetv2-nuscenes")
    infos = create_infos(args.data_root, version=args.version, val_scene_names=val,
                         out_prefix=prefix)
    print(f"wrote {prefix}_infos_train.pkl ({len(infos['train'])} samples) "
          f"and {prefix}_infos_val.pkl ({len(infos['val'])} samples)")
    return infos


def cmd_benchmark(args):
    """Serving benchmarks (counterpart of `cmd_benchmark`), in bf16 unless
    VEON_ENTRY_DTYPE names another dtype: `--eval` times the `test` loop on
    a synthetic shard (`utils/eval_bench.py`); `--artifact` an exported
    `.pt2` program; `--num-temporal > 1` the streaming step; else the live
    F=1 serving graph of --preset (`utils/bench_model.py` `measure`). The
    last three print one JSON line, which they return."""
    from ..utils import eval_bench  # it imports this module

    dtype = os.environ.get("VEON_ENTRY_DTYPE", "bfloat16")
    if args.eval_loop:
        return eval_bench.run(n_frames=args.frames, preset=args.preset, dtype=dtype,
                              workers=args.workers, raw_uint8=args.raw_uint8,
                              pipeline=args.pipeline, device=args.device)
    if args.artifact:
        line = _benchmark_artifact(args)
    elif args.num_temporal > 1:
        line = _benchmark_streaming(args, dtype)
    else:
        fps, detail = bench_model.measure(args.preset, dtype, iters=BENCH_ITERS,
                                          device=args.device)
        line = {"metric": f"{args.preset}_6cam_frames_per_sec_per_chip", "value": fps,
                "unit": "frames/s", "detail": detail}
    print(json.dumps(line))
    return line


BENCH_ITERS = 10  # back-to-back calls per timed run (JAX's on-device loop length)


@torch.no_grad()
def _benchmark_streaming(args, dtype: str, n_iters: int = BENCH_ITERS):
    """Steady streaming frames/s (counterpart of `_benchmark_streaming`, the
    reference's `benchmark_sequential.py`): each timed call is one serving
    step of `utils/export.py` `_build_streaming` whose early_vox rolls into
    the next call's prev_vox, as JAX's scan carry does, on perturbed frames
    (`bench_model` protocol)."""
    step, (imgs, depth_imgs, m1, ovw, prev_vox, prev_l2g, te) = _build_streaming(
        args.preset, args.num_temporal, compute_dtype=dtype, device=args.device)
    cache = [prev_vox]

    def call(imgs, depth_imgs):
        pv = cache[0]
        out = step(imgs, depth_imgs, m1, ovw, pv, prev_l2g, te)
        cache[0] = torch.cat([out["early_vox"][:, None].to(pv.dtype), pv[:, :-1]], 1)

    per, first_s = bench_model.timed_runs(
        call, bench_model.perturbed((imgs, depth_imgs), n_iters, (0, 1)), device=args.device)
    return {"metric": f"{args.preset}_streaming_t{args.num_temporal}_frames_per_sec",
            "value": 1.0 / per, "unit": "frames/s",
            "detail": {"ms_per_frame": per * 1e3, "compute_dtype": dtype, "iters": n_iters,
                       "first_call_s": first_s}}


@torch.no_grad()
def _benchmark_artifact(args, n_iters: int = BENCH_ITERS, outer: int = 3):
    """Deployed-artifact frames/s (counterpart of `_benchmark_artifact`, the
    reference's `benchmark_trt.py`): the `.pt2` program itself, loaded
    without the model's code, under the `bench_model` protocol. It runs on
    the example inputs saved in the program, every float leaf perturbed per
    call. JAX feeds zeros to the integer leaves instead, which for the
    presorted lift's order / rank streams would put every point in cell 0
    and time kernel #1 on one cell; the saved streams are the fixed rig's,
    the served workload."""
    t0 = time.perf_counter()
    saved = load_program(args.artifact)
    program = saved.module()
    load_s = time.perf_counter() - t0
    leaves, spec = pytree.tree_flatten(tuple(saved.example_inputs[0]))
    floats = [i for i, x in enumerate(leaves) if x.is_floating_point()]
    calls = [pytree.tree_unflatten(list(c), spec)
             for c in bench_model.perturbed(leaves, n_iters, floats)]
    per, first_s = bench_model.timed_runs(program, calls, outer=outer, device=leaves[0].device)
    name = os.path.splitext(os.path.basename(args.artifact))[0]
    return {"metric": f"{name}_artifact_frames_per_sec", "value": 1.0 / per, "unit": "frames/s",
            "detail": {"ms_per_frame": per * 1e3, "n_inputs": len(leaves), "iters": n_iters,
                       "first_call_s": first_s, "load_s": load_s}}


def cmd_export(args):
    """Serving export (counterpart of `cmd_export`, the reference's
    `tools/convert_bevdet_to_TRT.py`): the F=1 serving graph of --preset in
    bf16 (the flagship's, `export_flagship`) to <work-dir>/veon_infer.pt2,
    or with --num-temporal > 1 the streaming step in the preset's dtype to
    <work-dir>/veon_infer_t<N>.pt2, with --raw-uint8 taking raw uint8
    frames. With --native, the bundle of `utils/export.py` `export_native_bundle` for
    the C++ daemon and runner, to <work-dir>/veon_native[_t<N>]/: the
    streaming step of any preset with --num-temporal > 1, else the veon_b
    flagship (--split-output K chunks its grid) or the veon_tiny_test smoke
    bundle, as JAX's rules. Returns the path."""
    if args.raw_uint8 and args.num_temporal <= 1:
        raise SystemExit("export --raw-uint8 needs --num-temporal > 1 (the streaming step "
                         "exporter); the single-frame flagship artifact is the entry() graph, "
                         "which is frozen at normalized-float inputs")
    t0 = time.perf_counter()
    if args.native:
        return _export_native(args, t0)
    if args.num_temporal > 1:
        path = os.path.join(args.work_dir, f"veon_infer_t{args.num_temporal}.pt2")
        export_streaming(path, preset=args.preset, num_temporal=args.num_temporal,
                         raw_uint8=args.raw_uint8, device=args.device)
    else:
        path = export_flagship(os.path.join(args.work_dir, "veon_infer.pt2"),
                               preset=args.preset, device=args.device)
    print(f"exported: {path} ({os.path.getsize(path)} bytes, "
          f"{time.perf_counter() - t0:.3f} s)")
    return path


def _export_native(args, t0):
    outdir = os.path.join(args.work_dir, f"veon_native_t{args.num_temporal}"
                          if args.num_temporal > 1 else "veon_native")
    if args.num_temporal > 1:
        export_streaming_native(outdir, preset=args.preset, num_temporal=args.num_temporal,
                                raw_uint8=args.raw_uint8, device=args.device)
    elif args.preset == "veon_tiny_test":
        export_tiny_native(outdir, split_output=args.split_output, device=args.device)
    elif args.preset == "veon_b":
        export_flagship_native(outdir, split_output=args.split_output, device=args.device)
    else:
        # the single-frame bundle is the flagship graph: shipping veon_b under
        # another preset's name would serve a daemon that refuses its shapes
        raise SystemExit("export --native without --num-temporal exports the veon_b flagship "
                         "graph only (or veon_tiny_test for the daemon's smoke bundle); use "
                         "--num-temporal > 1 for a streaming bundle of any preset")
    print(f"exported native bundle: {outdir} ({time.perf_counter() - t0:.3f} s; see "
          f"manifest.json serve_cmd)")
    return outdir


def cmd_parity(args):
    """Weights-day activation parity (counterpart of `cmd_parity`): a
    reference dump directory (written by the JAX package's standalone
    `parity/dump_reference.py` inside the reference's torch environment)
    replayed through the converted-weight model, every module boundary
    checked within its tolerance (`parity/compare.py`; reference
    boundaries `san_in_veon_temporal.py:113-218`). Prints the table, the
    dump's bytes, the compare's seconds and the process's peak host
    memory; exits 1 on any failed boundary. Returns the rows."""
    import resource

    from ..parity.compare import compare_dumps, format_report

    if not args.dumps:
        raise SystemExit("parity needs --dumps <dir> (see veon_tpu/parity/dump_reference.py for "
                         "producing one in the reference environment)")
    cfg = build_cfg(args)
    if args.weights_dir:
        paths = resolve_weights_dir(args.weights_dir, args.preset)
        san, depth = paths["san"], paths["depth"]
        bpe = args.bpe_path or paths.get("bpe")
    else:
        san, depth, bpe = args.load_from, args.depth_load_from, args.bpe_path
    model, _tower, _ovw, _membership, _extras = build_model_and_params(
        cfg, san, depth, bpe, device=args.device)
    if not san:
        print("WARNING: no --weights-dir/--load-from — comparing against RANDOM init "
              "(harness smoke only, boundaries WILL fail)")
    nbytes = sum(os.path.getsize(os.path.join(args.dumps, f)) for f in os.listdir(args.dumps))
    t = time.perf_counter()
    rows = compare_dumps(args.dumps, model, num_cams=cfg.data.num_cams)
    seconds = time.perf_counter() - t
    print(format_report(rows))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"dump {nbytes} bytes; compare {seconds:.3f} s; peak host memory of the process "
          f"{peak / 2**30:.3f} GiB")
    if any(r["ok"] is False for r in rows):
        raise SystemExit(1)
    return rows


def cmd_vis(args):
    """Occupancy visualization (counterpart of `cmd_vis`;
    `san_in_veon_entry_temporal.py:172-241` visualize and the BEV images of
    `nuscenes_dataset_occ.py:88-108`): the first sample of --ann when it is
    readable, else the synthetic batch, through the full forward, the
    vocabulary merge and the fusion rule; writes occ_bev.png,
    occ_slices.png, occ_points.ply / .npy (one point per non-free voxel)
    and semseg_cam<n>.png per camera to --work-dir. Returns the paths."""
    from ..utils.vis import (denormalize_clipsan, save_png, semseg_overlay, vis_occ_bev,
                             vis_occ_height_slices, vis_occ_pointcloud)

    cfg = build_cfg(args)
    model, _tower, ovw, membership, _extras = build_model_and_params(
        cfg, args.load_from, args.depth_load_from, args.bpe_path, device=args.device)
    dev = ovw.device
    if os.path.exists(args.ann):
        ds = NuScenesOccDataset(
            infos=load_infos(args.ann), data_cfg=cfg.data, grid=cfg.grid,
            num_temporal=cfg.num_temporal, is_train=False, data_root=args.data_root,
            load_lidar_depth=False, raw_uint8=False)  # floats: the overlays denormalize
        batch = next(iter(DataLoader(ds, batch_size=1, shuffle=False, num_workers=1,
                                     drop_last=False)))
        imgs, depth_imgs, metas = (_to_device(batch[k], dev)
                                   for k in ("imgs", "depth_imgs", "metas"))
    else:
        imgs, depth_imgs, metas = example_batch_full(cfg, device=dev)
    with torch.no_grad():
        out = model.full_forward(imgs, depth_imgs, metas, ovw)
        pred = fused_classes(out, membership).cpu().numpy()
    sem_seg = out["sem_seg_ds"].cpu().numpy()
    os.makedirs(args.work_dir, exist_ok=True)
    paths = {k: os.path.join(args.work_dir, f) for k, f in (
        ("bev", "occ_bev.png"), ("slices", "occ_slices.png"), ("ply", "occ_points.ply"),
        ("npy", "occ_points.npy"))}
    save_png(paths["bev"], vis_occ_bev(pred[0]))
    save_png(paths["slices"], vis_occ_height_slices(pred[0]))
    g = cfg.grid
    verts = vis_occ_pointcloud(pred[0], grid_range=(g.x[:2], g.y[:2], g.z[:2]),
                               ply_path=paths["ply"], npy_path=paths["npy"])
    img0 = imgs[0, 0].cpu().numpy()  # (N, H, W, 3), the current frame
    paths["semseg"] = []
    for n in range(img0.shape[0]):
        ov = semseg_overlay(denormalize_clipsan(img0[n]), np.argmax(sem_seg[0, n], axis=-1),
                            num_classes=sem_seg.shape[-1])
        paths["semseg"].append(os.path.join(args.work_dir, f"semseg_cam{n}.png"))
        save_png(paths["semseg"][-1], ov)
    print("wrote", paths["bev"], ",", paths["slices"], f", occ_points.ply ({len(verts)} voxels)",
          f"and {img0.shape[0]} semseg overlays in", args.work_dir)
    return paths


COMMANDS = {"serve": cmd_serve, "selftest": cmd_selftest, "train": cmd_train,
            "pretrain-depth": cmd_pretrain_depth, "publish": cmd_publish, "test": cmd_test,
            "cache-depth": cmd_cache_depth, "create-infos": cmd_create_infos,
            "benchmark": cmd_benchmark, "parity": cmd_parity, "vis": cmd_vis,
            "export": cmd_export}
_TRAIN = ("train", "pretrain-depth")
_MODEL = ("serve", "selftest", "test", "cache-depth", "benchmark", "parity", "vis",
          "export") + _TRAIN
# the commands whose model takes frame counts and text
_FRAMES = ("serve", "selftest", "test", "train", "parity", "vis")
_DATA = ("test", "cache-depth") + _TRAIN
# (flags, argparse keywords, the subcommands that take the option); names
# and defaults are the reference CLI's
OPTIONS = (
    (("--preset",), dict(default="veon_b", help="veon_b, veon_b_fast, veon_b_fast2, veon_l, "
                                                "veon_b_zoe, veon_l_zoe or veon_tiny_test"),
     _MODEL),
    (("--num-temporal",), dict(type=int, default=1), _FRAMES + ("benchmark", "export")),
    (("--device",), dict(default="cuda", help="cuda, or cpu for the plain versions"), _MODEL),
    (("--bpe-path",), dict(default=None, help="CLIP bpe_simple_vocab_16e6.txt.gz for exact "
                                              "tokenization"), _FRAMES),
    (("--weights-dir",), dict(default=None, help="reference-README ckpts/ layout: selftest runs "
                              "the weights-arrival drill (convert + load + forward + tiny "
                              "mIoU), parity compares the converted model"),
     ("selftest", "parity")),
    (("--dumps",), dict(default=None, help="reference dump directory (inputs.npz, "
                        "boundaries.npz, manifest.json) from dump_reference.py"), ("parity",)),
    (("--socket",), dict(default="/tmp/veon_serve.sock", help="unix socket path"), ("serve",)),
    (("--raw-uint8",), dict(action="store_true", help="serve / export --num-temporal > 1: "
                            "accept raw uint8 RGB frames; test / cache-depth / benchmark "
                            "--eval: the loader ships post-aug uint8 frames; either way they "
                            "are normalized on the device"),
     ("serve", "test", "cache-depth", "benchmark", "export")),
    (("--cam-shards",), dict(type=int, default=1, help="shard the cameras over this many "
                             "processes (serve: the whole world; train: (world / this) batch "
                             "rows of this many)"),
     ("serve", "train")),
    (("--load-from",), dict(default=None, help="reference SAN/VEON semantic .pth"),
     ("serve", "test", "train", "parity", "vis")),
    (("--depth-load-from",), dict(default=None, help="reference depth .pth of the preset's "
                                                     "branch: DA-V2, or ZoeDepth-NK for a zoe "
                                                     "preset"),
     ("serve", "test", "cache-depth", "parity", "vis") + _TRAIN),
    (("--data-root",), dict(default="data/nuscenes"), _DATA + ("create-infos", "vis")),
    (("--ann",), dict(default="data/nuscenes/bevdetv2-nuscenes_infos_train.pkl"),
     _DATA + ("vis",)),
    (("--workers",), dict(type=int, default=2, help="loader workers"), _DATA + ("benchmark",)),
    (("--batch-size",), dict(type=int, default=1), ("cache-depth",) + _TRAIN),
    (("--work-dir",), dict(default="work_dir", help="training checkpoints step_<n>/ and "
                           "train.log.jsonl; test --all-ckpts sweeps it; vis writes its "
                           "images there; export its .pt2"), ("test", "vis", "export") + _TRAIN),
    (("--accum-steps",), dict(type=int, default=1, help="gradient accumulation micro-steps per "
                              "optimizer update (effective batch = batch-size x this)"), _TRAIN),
    (("--lr",), dict(type=float, default=1e-4), _TRAIN),
    (("--epochs",), dict(type=int, default=24), _TRAIN),
    (("--depth-cache",), dict(default=None, help="cached metric depth (cache-depth's output) "
                              "in place of the frozen depth tower"), ("train",)),
    (("--auto-resume",), dict(action="store_true", help="resume from the latest checkpoint in "
                              "--work-dir"), ("train",)),
    (("--temporal-start-epoch",), dict(type=int, default=0, help="epoch at which previous "
                                       "frames engage"), ("train",)),
    (("--remat",), dict(default="full", help="training recompute: full (each scan-stacked "
                        "block recomputed in the backward, default), none, or a "
                        "jax.checkpoint_policies name saved from recompute: "
                        "everything_saveable, dots_saveable, dots_with_no_batch_dims_saveable "
                        "(nn/rematutil.py)"), ("train",)),
    (("--dist-coordinator",), dict(default=None, help="host:port of process 0 (multi-process "
                                   "training or camera-sharded serving; also read from "
                                   "MASTER_ADDR/MASTER_PORT)"), ("serve", "train")),
    (("--dist-num-processes",), dict(type=int, default=None, help="world size, one process per "
                                     "card (also read from WORLD_SIZE, or from NNODES where "
                                     "each host has one card)"), ("serve", "train")),
    (("--dist-process-id",), dict(type=int, default=None, help="this process's rank (also read "
                                  "from RANK or NODE_RANK)"), ("serve", "train")),
    (("--pipeline",), dict(type=int, default=1, help="predictions in flight in the eval loop "
                           "(1: strictly serial; 2: frame N+1 uploaded and enqueued before "
                           "frame N's grid is read back)"), ("test", "benchmark")),
    (("--fuse-conv-bn",), dict(action="store_true", help="fold BN into convs at eval"),
     ("test",)),
    (("--retrieval",), dict(action="store_true",
                            help="POP-3D retrieval eval instead of Occ3D mIoU"), ("test",)),
    (("--retrieval-items",), dict(default=None, help="retrieval_anns csv, or a json list of "
                                  "{token, prompt, anno_file, points_file}"), ("test",)),
    (("--ckpt",), dict(default=None, help="training checkpoint step_<n> (or a published one)"),
     ("test", "publish")),
    (("--ema",), dict(action="store_true", help="the checkpoint's EMA shadow"),
     ("test", "publish")),
    (("--all-ckpts",), dict(action="store_true", help="evaluate every checkpoint in "
                            "--work-dir"), ("test",)),
    (("--sweep-from",), dict(type=int, default=None, help="test --all-ckpts: skip "
                             "checkpoints below this step"), ("test",)),
    (("--sweep-to",), dict(type=int, default=None, help="test --all-ckpts: skip checkpoints "
                           "above this step"), ("test",)),
    (("--cache-dir",), dict(default="data/nuscenes/depth_cache/depth_dav2"), ("cache-depth",)),
    (("--version",), dict(default="v1.0-trainval", help="nuScenes table version directory"),
     ("create-infos",)),
    (("--val-scenes",), dict(default=None, help="comma-separated scene names, or a file with "
                             "one name per line, routed to the val split"), ("create-infos",)),
    (("--out-prefix",), dict(default=None, help="create-infos: output pickle prefix (default "
                             "<data-root>/bevdetv2-nuscenes); publish: the output path, "
                             "stamped -<sha8>"), ("create-infos", "publish")),
    (("--eval",), dict(dest="eval_loop", action="store_true", help="time the `test` eval "
                       "loop on a synthetic shard"), ("benchmark",)),
    (("--frames",), dict(type=int, default=12, help="benchmark --eval: synthetic shard size"),
     ("benchmark",)),
    (("--artifact",), dict(default=None, help="time an exported .pt2 program (export's "
                           "output) instead of the live model"), ("benchmark",)),
    (("--native",), dict(action="store_true", help="write the native bundle (an AOTInductor "
                         "package, bind/*.npy, manifest.json) that veon_serve_host and "
                         "veon_aoti_runner serve with no Python"), ("export",)),
    (("--split-output",), dict(type=int, default=1, help="export --native at F=1: return the "
                               "class grid as K chunks along X (manifest split_concat)"),
     ("export",)),
)


def parser() -> argparse.ArgumentParser:
    """The command line: each subcommand with its options."""
    ap = argparse.ArgumentParser(prog="veon_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    subs = {name: sub.add_parser(name) for name in COMMANDS}
    for name, fn in COMMANDS.items():
        subs[name].set_defaults(fn=fn)
    for flags, kw, names in OPTIONS:
        for name in names:
            subs[name].add_argument(*flags, **kw)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
