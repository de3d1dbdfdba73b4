"""Command line of the port (counterpart of `veon_tpu/cli/main.py`): the
`serve`, `selftest`, `test` (Occ3D mIoU, or POP-3D retrieval AP with
--retrieval), `cache-depth`, `create-infos` and `benchmark --eval`
subcommands. `text_classifier`, the counterpart of the reference's
`_text_classifier`, lives in `nn/text.py` and is re-exported here.

    python -m veon_tpu_torch.cli.main serve --preset veon_b \
        --socket /tmp/veon.sock [--num-temporal 2] [--raw-uint8] \
        [--load-from SAN_ViT-B.pth --depth-load-from depth.pth] \
        [--bpe-path bpe_simple_vocab_16e6.txt.gz]
    python -m veon_tpu_torch.cli.main selftest [--weights-dir ckpts/]
    python -m veon_tpu_torch.cli.main test --data-root data/nuscenes \
        --ann data/nuscenes/bevdetv2-nuscenes_infos_val.pkl \
        [--pipeline 2] [--raw-uint8] [--fuse-conv-bn] [--num-temporal 2] \
        [--retrieval --retrieval-items retrieval_anns_val.csv]
    python -m veon_tpu_torch.cli.main cache-depth --ann ... --cache-dir ...
    python -m veon_tpu_torch.cli.main create-infos --data-root data/nuscenes \
        [--version v1.0-trainval] [--val-scenes val.txt] [--out-prefix ...]
    python -m veon_tpu_torch.cli.main benchmark --eval [--frames 12]

Every command that runs the model runs on the card unless --device cpu.

The server answers `serve/client.py` `TensorClient` (and the JAX
package's python and C++ clients): F=1 requests carry imgs and
depth_imgs, streaming requests (--num-temporal > 1) one frame each plus
lidarego2global; either may add text_embed (C,) or text_tokens (1, 77)
int32 for a free-text `retrieval` map. The CLI computes in the preset's
dtype (fp32 for every preset, as the reference's CLI); `benchmark --eval`
in bf16 unless VEON_ENTRY_DTYPE names another. Weights come from the
reference's PyTorch checkpoints (`--load-from`, `--depth-load-from`,
converted by `ckpt/convert.py`, LoRA folded in), else seeded stand-ins;
`entry.serve_entry` also takes JAX variables and text-tower params.
Orbax checkpoints (--ckpt and its sweep options) wait for ROADMAP Queue 1
item 11a, the live-model and exported-artifact benchmarks for items 23
and 21.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..ckpt import convert as C
from ..ckpt.from_jax import load_families, load_from_jax, variables_from_model
from ..cli.shapes import example_batch, example_batch_full
from ..configs import presets
from ..data.create_infos import create_infos
from ..data.loader import DataLoader
from ..data.nuscenes import (NuScenesOccDataset, NuScenesRetrievalDataset, load_infos,
                             load_retrieval_csv)
from ..data.transforms import normalize_in_graph
from ..entry import build_model, serve_entry, serving_model
from ..eval.miou import MIoUMetric
from ..eval.retrieval import retrieval_scores
from ..model.veon import fused_classes
from ..nn import text as text_mod
from ..nn.text import text_classifier  # noqa: F401  (the CLI's `_text_classifier`)
from ..serve.server import TensorServer
from ..train.loop import _to_device, evaluate_occ, write_depth_cache


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
    DA-V2 dump (depth, its LoRA adapters folded in with scale
    lora_alpha / r); variables None without either file. extras holds the
    semantic dump's text tower, bg_embed and logit_scale where it has them."""
    params, stats, extras = {}, {}, {}
    if san_ckpt:
        params, stats, extras = C.convert_san_semantic(C.load_torch_state_dict(san_ckpt), cfg)
    if depth_ckpt:
        depth = C.convert_dav2(C.load_torch_state_dict(depth_ckpt), cfg.depth)
        params = dict(params, depth=C.merge_lora(depth, cfg.depth.lora_alpha))
    return ({"params": params, "batch_stats": stats} if params else None), extras


def checkpoint_model(cfg, variables, device="cuda", seed: int = 0):
    """The model on `device` as the reference's CLI builds it from its
    checkpoints: a seeded init with each converted family of `variables`
    (`load_checkpoints`) loaded over it, strict on both sides within the
    family (`from_jax.load_families`, the counterpart of merging the
    converted families into the init tree); seeded alone without
    variables. Only this route fills a partial tree: the entry points load
    a whole tree strictly."""
    model = build_model(cfg, resolve_device(device), seed, None)
    if variables is not None:
        load_families(model, variables)
    return model


def build_model_and_params(cfg, san_ckpt=None, depth_ckpt=None, bpe_path=None, device="cuda",
                           seed: int = 0):
    """(model, text tower, open-vocabulary weight, merge matrix, extras)
    (counterpart of `_build_model_and_params`): the checkpoints converted
    and loaded family by family (`checkpoint_model`), the rest seeded; the
    classifier from the checkpoint's text tower, bg_embed and logit_scale,
    with the reference's refusals (no BPE merges, another vocabulary size),
    else the placeholder N(0, 1) of default_rng(0)."""
    variables, extras = load_checkpoints(cfg, san_ckpt, depth_ckpt)
    model, tower, ovw, membership = serving_model(
        cfg, device, seed, None, extras.get("text_tower"), extras.get("bg_embed"),
        extras.get("logit_scale"), bpe_path, checkpoint_model(cfg, variables, device, seed))
    return model, tower, ovw, membership, extras


def build_serve_handler(args):
    """(handler, required request keys, expectation string, exclusive) for
    `cmd_serve`, built by `entry.serve_entry` on `checkpoint_model`; split
    out so tests and `chip_smoke.py` mount the handler on their own
    `TensorServer`."""
    if getattr(args, "cam_shards", 1) > 1:
        raise NotImplementedError("camera-sharded serving (--cam-shards > 1) is not ported "
                                  "yet: ROADMAP Queue 1 item 16")
    cfg = build_cfg(args)
    variables, extras = load_checkpoints(cfg, args.load_from, args.depth_load_from)
    return serve_entry(cfg, device=args.device, model=checkpoint_model(cfg, variables, args.device),
                       text_tower=extras.get("text_tower"), bg_embed=extras.get("bg_embed"),
                       logit_scale=extras.get("logit_scale"), bpe_path=args.bpe_path,
                       raw_uint8=args.raw_uint8)


def cmd_serve(args):
    """Bind the model, rig precompute and classifier on the device and
    answer requests over a unix socket until interrupted."""
    handler, required, expect, exclusive = build_serve_handler(args)
    srv = TensorServer(handler, args.socket, required=required, exclusive=exclusive)
    srv.start()
    print(f"serving on {args.socket} ({expect}); ctrl-c to stop", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


def resolve_weights_dir(weights_dir: str, preset: str):
    """{"san", "depth"[, "bpe"]: path} in the reference README's checkpoint
    layout under weights_dir (counterpart of `_resolve_weights_dir`):

      clipsan/SAN_ViT-B.pth | SAN_ViT-L.pth   (or raw san_vit_b_16.pth /
                                               san_vit_large_14.pth)
      depth_pretrain/depthanythingv2_pretrain_large.pth  (finetuned; or the
        published depthanythingv2/depth_anything_v2_metric_vkitti_vitl.pth)
      bpe_simple_vocab_16e6.txt.gz                       (CLIP tokenizer)

    A missing checkpoint raises FileNotFoundError naming each."""
    large = "_l" in preset
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
    pick("depth", ["depth_pretrain/depthanythingv2_pretrain_large.pth",
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


def cmd_test(args):
    """Occ3D evaluation (counterpart of `cmd_test`): the val infos through
    the dataset and loader, one fusion-rule class grid per sample, the
    camera-masked mIoU; with --retrieval the POP-3D evaluation instead.
    Prints and returns the metrics."""
    if args.ckpt or args.ema or args.all_ckpts or args.sweep_from is not None \
            or args.sweep_to is not None:
        raise NotImplementedError("orbax checkpoints (--ckpt, --ema, --all-ckpts, --sweep-from, "
                                  "--sweep-to) are not ported yet: ROADMAP Queue 1 item 11a "
                                  "(ckpt/io.py)")
    if args.retrieval:
        return cmd_test_retrieval(args)
    cfg = build_cfg(args)
    model, _tower, ovw, membership, _extras = build_model_and_params(
        cfg, args.load_from, args.depth_load_from, args.bpe_path, device=args.device)
    if args.fuse_conv_bn:
        fuse_model_conv_bn(model)
    ds = NuScenesOccDataset(
        infos=load_infos(args.ann), data_cfg=cfg.data, grid=cfg.grid,
        num_temporal=cfg.num_temporal, is_train=False, data_root=args.data_root,
        load_lidar_depth=False, raw_uint8=cfg.data.raw_uint8)
    loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=args.workers,
                        drop_last=False)
    predict = occ_predictor(model, membership, cfg.data.depth_norm_method, cfg.data.raw_uint8)
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
    """`benchmark --eval`: the `test` loop timed on a synthetic shard
    (`utils/eval_bench.py`), in bf16 unless VEON_ENTRY_DTYPE says otherwise."""
    from ..utils import eval_bench  # it imports this module

    if args.artifact:
        raise NotImplementedError("benchmarking an exported artifact (--artifact) is not ported "
                                  "yet: ROADMAP Queue 1 item 21")
    if not args.eval_loop:
        raise NotImplementedError("the live-model and streaming benchmarks (benchmark without "
                                  "--eval) are not ported yet: ROADMAP Queue 1 item 23")
    return eval_bench.run(n_frames=args.frames, preset=args.preset,
                          dtype=os.environ.get("VEON_ENTRY_DTYPE", "bfloat16"),
                          workers=args.workers, raw_uint8=args.raw_uint8,
                          pipeline=args.pipeline, device=args.device)


COMMANDS = {"serve": cmd_serve, "selftest": cmd_selftest, "test": cmd_test,
            "cache-depth": cmd_cache_depth, "create-infos": cmd_create_infos,
            "benchmark": cmd_benchmark}
_MODEL = ("serve", "selftest", "test", "cache-depth", "benchmark")
_FRAMES = ("serve", "selftest", "test")  # the commands whose model takes frame counts and text
_DATA = ("test", "cache-depth")
# (flags, argparse keywords, the subcommands that take the option); names
# and defaults are the reference CLI's
OPTIONS = (
    (("--preset",), dict(default="veon_b", help="veon_b, veon_b_fast, veon_b_fast2, veon_l "
                                                "or veon_tiny_test"), _MODEL),
    (("--num-temporal",), dict(type=int, default=1), _FRAMES),
    (("--device",), dict(default="cuda", help="cuda, or cpu for the plain versions"), _MODEL),
    (("--bpe-path",), dict(default=None, help="CLIP bpe_simple_vocab_16e6.txt.gz for exact "
                                              "tokenization"), _FRAMES),
    (("--weights-dir",), dict(default=None, help="reference-README ckpts/ layout: runs the "
                              "weights-arrival drill (convert + load + forward + tiny mIoU)"),
     ("selftest",)),
    (("--socket",), dict(default="/tmp/veon_serve.sock", help="unix socket path"), ("serve",)),
    (("--raw-uint8",), dict(action="store_true", help="serve: accept raw uint8 RGB frames; "
                            "test / cache-depth / benchmark --eval: the loader ships post-aug "
                            "uint8 frames; either way they are normalized on the device"),
     ("serve", "test", "cache-depth", "benchmark")),
    (("--cam-shards",), dict(type=int, default=1, help="not ported: must be 1"), ("serve",)),
    (("--load-from",), dict(default=None, help="reference SAN/VEON semantic .pth"),
     ("serve", "test")),
    (("--depth-load-from",), dict(default=None, help="reference DA-V2 depth .pth"),
     ("serve", "test", "cache-depth")),
    (("--data-root",), dict(default="data/nuscenes"), _DATA + ("create-infos",)),
    (("--ann",), dict(default="data/nuscenes/bevdetv2-nuscenes_infos_train.pkl"), _DATA),
    (("--workers",), dict(type=int, default=2, help="loader workers"), _DATA + ("benchmark",)),
    (("--batch-size",), dict(type=int, default=1), ("cache-depth",)),
    (("--pipeline",), dict(type=int, default=1, help="predictions in flight in the eval loop "
                           "(1: strictly serial; 2: frame N+1 uploaded and enqueued before "
                           "frame N's grid is read back)"), ("test", "benchmark")),
    (("--fuse-conv-bn",), dict(action="store_true", help="fold BN into convs at eval"),
     ("test",)),
    (("--retrieval",), dict(action="store_true",
                            help="POP-3D retrieval eval instead of Occ3D mIoU"), ("test",)),
    (("--retrieval-items",), dict(default=None, help="retrieval_anns csv, or a json list of "
                                  "{token, prompt, anno_file, points_file}"), ("test",)),
    (("--ckpt",), dict(default=None, help="orbax checkpoint: not ported"), ("test",)),
    (("--ema",), dict(action="store_true", help="not ported"), ("test",)),
    (("--all-ckpts",), dict(action="store_true", help="not ported"), ("test",)),
    (("--sweep-from",), dict(type=int, default=None, help="not ported"), ("test",)),
    (("--sweep-to",), dict(type=int, default=None, help="not ported"), ("test",)),
    (("--cache-dir",), dict(default="data/nuscenes/depth_cache/depth_dav2"), ("cache-depth",)),
    (("--version",), dict(default="v1.0-trainval", help="nuScenes table version directory"),
     ("create-infos",)),
    (("--val-scenes",), dict(default=None, help="comma-separated scene names, or a file with "
                             "one name per line, routed to the val split"), ("create-infos",)),
    (("--out-prefix",), dict(default=None, help="output pickle prefix (default "
                             "<data-root>/bevdetv2-nuscenes)"), ("create-infos",)),
    (("--eval",), dict(dest="eval_loop", action="store_true", help="time the `test` eval "
                       "loop on a synthetic shard"), ("benchmark",)),
    (("--frames",), dict(type=int, default=12, help="benchmark --eval: synthetic shard size"),
     ("benchmark",)),
    (("--artifact",), dict(default=None, help="not ported"), ("benchmark",)),
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
