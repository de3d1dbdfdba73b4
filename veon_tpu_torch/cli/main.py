"""Command line of the port (counterpart of `veon_tpu/cli/main.py`): the
`serve` and `selftest` subcommands. `text_classifier`, the counterpart of
the reference's `_text_classifier`, lives in `nn/text.py` and is
re-exported here.

    python -m veon_tpu_torch.cli.main serve --preset veon_b \
        --socket /tmp/veon.sock [--num-temporal 2] [--raw-uint8] \
        [--load-from SAN_ViT-B.pth --depth-load-from depth.pth] \
        [--bpe-path bpe_simple_vocab_16e6.txt.gz]
    python -m veon_tpu_torch.cli.main selftest [--weights-dir ckpts/]

The server answers `serve/client.py` `TensorClient` (and the JAX
package's python and C++ clients): F=1 requests carry imgs and
depth_imgs, streaming requests (--num-temporal > 1) one frame each plus
lidarego2global; either may add text_embed (C,) or text_tokens (1, 77)
int32 for a free-text `retrieval` map. It computes in the preset's dtype
(fp32 for every preset, as the reference's CLI). Weights come from the
reference's PyTorch checkpoints (`--load-from`, `--depth-load-from`,
converted by `ckpt/convert.py`, LoRA folded in), else seeded stand-ins;
`entry.serve_entry` also takes JAX variables and text-tower params.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..ckpt import convert as C
from ..ckpt.from_jax import load_families
from ..cli.shapes import example_batch, example_batch_full
from ..configs import presets
from ..entry import build_model, serve_entry, serving_model
from ..eval.miou import MIoUMetric
from ..model.veon import fused_classes
from ..nn import text as text_mod
from ..nn.text import text_classifier  # noqa: F401  (the CLI's `_text_classifier`)
from ..serve.server import TensorServer


def build_cfg(args):
    """The preset named by args with its frame count, in the preset's own
    compute dtype (fp32 for every preset, as the reference's CLI)."""
    return getattr(presets, args.preset)(num_temporal=args.num_temporal)


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


def parser() -> argparse.ArgumentParser:
    """The command line: `serve` and `selftest` and their options."""
    ap = argparse.ArgumentParser(prog="veon_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("serve", cmd_serve), ("selftest", cmd_selftest)):
        p = sub.add_parser(name)
        p.add_argument("--preset", default="veon_b",
                       help="veon_b, veon_b_fast, veon_b_fast2, veon_l or veon_tiny_test")
        p.add_argument("--num-temporal", type=int, default=1)
        p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
        p.add_argument("--bpe-path", default=None,
                       help="CLIP bpe_simple_vocab_16e6.txt.gz for exact tokenization")
        p.set_defaults(fn=fn)
        if name == "selftest":
            p.add_argument("--weights-dir", default=None,
                           help="reference-README ckpts/ layout: runs the weights-arrival "
                                "drill (convert + load + forward + tiny mIoU)")
            continue
        p.add_argument("--socket", default="/tmp/veon_serve.sock", help="unix socket path")
        p.add_argument("--raw-uint8", action="store_true",
                       help="accept raw uint8 RGB frames and normalize them on the device")
        p.add_argument("--cam-shards", type=int, default=1, help="not ported: must be 1")
        p.add_argument("--load-from", default=None, help="reference SAN/VEON semantic .pth")
        p.add_argument("--depth-load-from", default=None, help="reference DA-V2 depth .pth")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
