"""Whole-graph FLOP and byte audit of the VEON serving graph (counterpart
of `veon_tpu/utils/roofline.py`): the forward work of each stage of the
single-frame serving graph at production shapes (B=1, 6 cameras), stage
for stage JAX's count, so a measured frame time reads as a share of its
floor. The stages follow `model/veon.py` `full_forward`.

FLOPs are forward-only multiply-adds x 2; bytes are the least device
memory traffic (inputs and parameters read once, outputs written once,
bf16 activations). Real traffic is higher, so `ms_floor` bounds each stage
from below. The rates default to the NVIDIA H100 SXM data sheet's dense
bf16 tensor-core peak (989 TFLOP/s, matmuls and convolutions alike) and
HBM3 rate (3.35 TB/s): data-sheet peaks, not measurements.

Usage: python -m veon_tpu_torch.utils.roofline [--preset veon_b] [--json]
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

from ..configs.base import VeonConfig

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 rate
H100_BF16_TFS = 989.0
H100_HBM_GBPS = 3350.0


def _tf(x):
    return x / 1e12


def transformer_layer(L: int, C: int, mlp_ratio: float = 4.0,
                      extra_qk: int = 0, cross_q: int = 0) -> Tuple[float, float]:
    """(flops, bytes_min) of one ViT encoder layer on L tokens of width C.

    extra_qk: augmented qk channels (HSA factorized bias fusion).
    cross_q:  extra cross-attention query tokens (rec-head sos stream).
    """
    d = C + extra_qk
    flops = (
        6 * L * C * C          # qkv
        + 2 * L * L * d        # q @ k^T
        + 2 * L * L * C        # attn @ v
        + 2 * L * C * C        # proj
        + 2 * 2 * L * C * (mlp_ratio * C)  # mlp fc1+fc2
    )
    if cross_q:
        flops += (
            6 * cross_q * C * C + 2 * cross_q * L * d + 2 * cross_q * L * C
            + 2 * cross_q * C * C + 4 * cross_q * C * (mlp_ratio * C)
        )
    # activations in/out in bf16 + attention matrix traffic (fp32 softmax);
    # param bytes are accounted separately by the caller (shared across the
    # camera batch — read once, not once per camera)
    bytes_min = 2 * (2 * L * C) + 4 * 2 * L * L
    return flops, bytes_min


def transformer_params(C: int, mlp_ratio: float = 4.0) -> float:
    return 2 * (4 * C * C + 2 * mlp_ratio * C * C)  # bf16 bytes per layer


def conv2d(H: int, W: int, cin: int, cout: int, k: int = 3,
           stride: int = 1) -> Tuple[float, float]:
    ho, wo = H // stride, W // stride
    flops = 2 * ho * wo * k * k * cin * cout
    # activations only; conv params accounted once per stage by the caller
    bytes_min = 2 * (H * W * cin + ho * wo * cout)
    return flops, bytes_min


def conv3d(Z: int, Y: int, X: int, cin: int, cout: int, k: int = 3):
    flops = 2 * Z * Y * X * k ** 3 * cin * cout
    bytes_min = 2 * (Z * Y * X * (cin + cout)) + 2 * k ** 3 * cin * cout  # B=1: params read once
    return flops, bytes_min


@dataclasses.dataclass
class Stage:
    name: str
    flops: float
    bytes_min: float
    note: str = ""

    def ms_floor(self, tf_rate: float, gbps: float) -> float:
        """max(compute, memory) time in ms at the given achievable rates."""
        return max(self.flops / (tf_rate * 1e9), self.bytes_min / (gbps * 1e6))


def audit_stages(cfg: VeonConfig, num_cams: int = 6) -> List[Stage]:
    """Per-stage forward work for the single-frame serving graph, as JAX's
    `audit_stages` counts it."""
    N = num_cams
    H, W = cfg.data.input_size                       # 512, 1408
    # the DA-V2 input after the lower-bound multiple-of-14 resize, as the
    # pipeline sizes it
    from ..data.transforms import dav2_size

    dh, dw = dav2_size(H, W, cfg.data.dav2_target)   # 252 -> (252, 700)
    stages: List[Stage] = []

    # ---- depth tower --------------------------------------------------
    vit = cfg.depth.vit
    ph, pw = dh // 14, dw // 14
    Ld = ph * pw + 1
    f = b = 0.0
    for _ in range(vit.depth):
        fl, by = transformer_layer(Ld, vit.width)
        f += fl * N
        b += by * N
    f += 2 * ph * pw * (14 * 14 * 3) * vit.width * N  # patch embed
    b += vit.depth * transformer_params(vit.width)
    stages.append(Stage("depth_trunk", f, b,
                        f"DINOv2-{cfg.depth.encoder} {vit.depth}L @ {N}x({dh},{dw}) "
                        f"= {Ld} tok x {vit.width}"))

    # DPT head: projects + resize convs + 4 rn convs + 4 fusion blocks + out
    f = b = 0.0
    oc = cfg.depth.out_channels
    feat = cfg.depth.features
    for i, c in enumerate(oc):
        fl, by = conv2d(ph, pw, vit.width, c, k=1)
        f += fl * N; b += by * N
    # resize convs: deconv 4x (oc0), deconv 2x (oc1), stride-2 conv (oc3)
    fl, by = conv2d(ph * 4, pw * 4, oc[0], oc[0], k=1); f += fl * N; b += by * N
    fl, by = conv2d(ph * 2, pw * 2, oc[1], oc[1], k=1); f += fl * N; b += by * N
    fl, by = conv2d(ph, pw, oc[3], oc[3], k=3, stride=2); f += fl * N; b += by * N
    scales = [4, 2, 1, 0.5]
    for i, s in enumerate(scales):
        fl, by = conv2d(int(ph * s), int(pw * s), oc[i], feat, k=3)
        f += fl * N; b += by * N
    # fusion cascade: each level 2 RCUs (4 conv3x3 @ feat) + 1x1 out at 2x
    for s in [1, 2, 4, 8]:
        hh, ww = ph * s, pw * s
        for _ in range(4):
            fl, by = conv2d(hh, ww, feat, feat, k=3); f += fl * N; b += by * N
        fl, by = conv2d(hh * 2, ww * 2, feat, feat, k=1); f += fl * N; b += by * N
    fl, by = conv2d(ph * 8, pw * 8, feat, feat // 2, k=3); f += fl * N; b += by * N
    fl, by = conv2d(ph * 14, pw * 14, feat // 2, 32, k=3); f += fl * N; b += by * N
    b += 2 * 25e6  # ~25M DPT params bf16
    stages.append(Stage("dpt_head", f, b, f"DPT @ {N}x({ph}x{pw}..{ph*14}x{pw*14})"))

    # ---- CLIP shallow extractor --------------------------------------
    ch, cw = H // 2, W // 2
    gh, gw = ch // cfg.san.clip_patch_size, cw // cfg.san.clip_patch_size
    Lc = gh * gw + 1
    f = b = 0.0
    for _ in range(cfg.san.feature_last_layer_idx):
        fl, by = transformer_layer(Lc, cfg.san.clip_width)
        f += fl * N; b += by * N
    f += 2 * gh * gw * (cfg.san.clip_patch_size ** 2 * 3) * cfg.san.clip_width * N
    b += cfg.san.feature_last_layer_idx * transformer_params(cfg.san.clip_width)
    stages.append(Stage("clip_extractor", f, b,
                        f"CLIP {cfg.san.feature_last_layer_idx}L @ {N}x{Lc} tok "
                        f"x {cfg.san.clip_width}"))

    # ---- SAN side adapter --------------------------------------------
    sh, sw = H // cfg.san.side_patch_size, W // cfg.san.side_patch_size
    Ls = sh * sw + cfg.san.num_queries
    f = b = 0.0
    for _ in range(cfg.san.side_depth):
        fl, by = transformer_layer(Ls, cfg.san.side_width)
        f += fl * N; b += by * N
    f += 2 * sh * sw * (cfg.san.side_patch_size ** 2 * 3) * cfg.san.side_width * N
    # fusion neck denses clip->side per fusion_map + mask decoder MLPs
    for _blk, cl in cfg.san.fusion_map:
        f += 2 * gh * gw * cfg.san.clip_width * cfg.san.side_width * N
    # attn-bias decoder: query mlp (3 layers) + pix conv + bias einsum
    ab = cfg.san.attn_bias_embed_channels
    f += 2 * cfg.san.num_queries * cfg.san.side_width * ab * 3 * N
    f += 2 * sh * sw * cfg.san.side_width * ab * N
    f += 2 * cfg.san.num_queries * sh * sw * ab * N * (cfg.san.attn_bias_heads)
    b += cfg.san.side_depth * transformer_params(cfg.san.side_width)
    stages.append(Stage("side_adapter", f, b,
                        f"SAN w{cfg.san.side_width} {cfg.san.side_depth}L @ "
                        f"{N}x{Ls} tok (+decoder)"))

    # ---- rec head (sos cross-attn over deep CLIP) ---------------------
    n_deep = cfg.san.clip_layers - cfg.san.feature_last_layer_idx
    f = b = 0.0
    for _ in range(n_deep):
        fl, by = transformer_layer(Lc, cfg.san.clip_width,
                                   cross_q=cfg.san.num_queries)
        f += fl * N; b += by * N
    b += n_deep * transformer_params(cfg.san.clip_width)
    stages.append(Stage("rec_head", f, b,
                        f"{n_deep}L deep CLIP + {cfg.san.num_queries} sos"))

    # ---- HSA ----------------------------------------------------------
    hh, hw = H // cfg.hsa.patch_shape[0], W // cfg.hsa.patch_shape[1]
    Lh = hh * hw
    d = cfg.hsa.dim
    f = b = 0.0
    f += 2 * Lh * (cfg.hsa.patch_shape[0] * cfg.hsa.patch_shape[1] * 3) * d * N
    n_blocks = len(cfg.hsa.fusion_map)
    for _ in range(n_blocks):
        for _c in range(2):
            fl, by = conv2d(hh, hw, d, cfg.hsa.mlp_dim, k=3)
            f += fl * N; b += by * N
        f += 2 * gh * gw * cfg.hsa.clip_dim * d * N  # neck_add
    # rear block: convffn (2 convs) + 2 head FFNs
    for _c in range(2):
        fl, by = conv2d(hh, hw, d, cfg.hsa.mlp_dim, k=3)
        f += fl * N; b += by * N
    attn_out = cfg.hsa.manip_attn_layers * cfg.hsa.num_heads * cfg.hsa.manip_dim_head
    f += 2 * Lh * cfg.hsa.mlp_dim * (cfg.hsa.mlp_dim + attn_out) * N
    f += 2 * Lh * cfg.hsa.mlp_dim * (cfg.hsa.mlp_dim + cfg.hsa.manip_supp_dim) * N
    # the LN tax: ~19 ln passes at (N, Lh, d) fp32 internal
    ln_elems = 19 * N * Lh * d
    b += 8 * ln_elems
    b += (8 * 2 * 9 * cfg.hsa.mlp_dim * d
          + 2 * 2 * cfg.hsa.mlp_dim * (attn_out + cfg.hsa.manip_supp_dim))
    stages.append(Stage("hsa", f, b,
                        f"{n_blocks}+1 conv-FFN blocks @ {N}x{Lh} tok x {d} "
                        f"(19 LN passes -> bytes)"))

    # ---- deep-CLIP re-run with HSA bias (update_remaining) ------------
    f = b = 0.0
    extra = cfg.hsa.manip_dim_head
    for _ in range(n_deep):
        fl, by = transformer_layer(Lc, cfg.san.clip_width, extra_qk=extra)
        f += fl * N; b += by * N
    f += 2 * gh * gw * cfg.san.clip_width * cfg.san.clip_embed_dim * N  # proj
    b += n_deep * transformer_params(cfg.san.clip_width)
    stages.append(Stage("deep_clip_rerun", f, b,
                        f"{n_deep}L @ {N}x{Lc} tok + {extra} aug-qk ch"))

    # ---- lift (two-hot + gather + pallas kernel) ----------------------
    lh, lw = H // cfg.lss_downsample, W // cfg.lss_downsample
    D = cfg.grid.num_depth_bins
    C = cfg.propagation.dim
    P = N * D * lh * lw
    in_grid = 0.58  # the in-grid share of the synthetic rig's points
    rows = int(P * in_grid)
    f = 2 * rows * C  # weight multiply
    # vals gather read+write + kernel stream read + out write (bf16)
    nxl, nyl, nzl = cfg.grid.scaled(cfg.lss_feat_ds).size
    b = 2 * rows * C * 3 + 2 * nxl * nyl * nzl * C
    stages.append(Stage("lift", f, b,
                        f"{rows / 1e3:.0f}k rows x {C}ch bf16 stream (in-grid "
                        f"{in_grid:.2f} of {P / 1e6:.2f}M)"))

    # ---- lift fusion (supp+clip -> lift features) ---------------------
    f = b = 0.0
    f += 2 * lh * lw * (cfg.hsa.manip_supp_dim + cfg.san.clip_width) * C * N
    fl, by = conv2d(lh, lw, C, C, k=3); f += fl * N; b += by * N
    stages.append(Stage("lift_fusion", f, b, f"cat-fuse @ {N}x({lh},{lw})"))

    # ---- alignnet -----------------------------------------------------
    f = b = 0.0
    for _ in range(cfg.propagation.layer_depth * 2):
        fl, by = conv3d(nzl, nyl, nxl, C, C, k=3)
        f += fl; b += by
    mid = C // 4
    fl, by = conv3d(nzl, nyl, nxl, C, mid, k=1); f += fl; b += by
    fl, by = conv3d(nzl, nyl, nxl, mid, 2, k=1); f += fl; b += by
    for cout in (C, C, cfg.propagation.clip_proj_dim):
        fl, by = conv3d(nzl, nyl, nxl, C, cout, k=1); f += fl; b += by
    stages.append(Stage("alignnet", f, b,
                        f"{cfg.propagation.layer_depth} ResBlock3D + heads @ "
                        f"({nzl},{nyl},{nxl}) x {C}"))

    # ---- output: trilinear upsample + classifier einsum ---------------
    nx, ny, nz = cfg.grid.size
    V = nx * ny * nz
    n_prompts = 67
    cp = cfg.propagation.clip_proj_dim
    f = 2 * V * cp * n_prompts + 8 * V * cp
    b = 2 * V * (cp + n_prompts + 2) + 2 * nxl * nyl * nzl * cp
    stages.append(Stage("output", f, b,
                        f"trilinear to ({nz},{ny},{nx}) + ovw einsum {n_prompts}cls"))
    return stages


def print_audit(cfg: VeonConfig, tf_rate_matmul: float = H100_BF16_TFS,
                tf_rate_conv: float = H100_BF16_TFS, gbps: float = H100_HBM_GBPS,
                as_json: bool = False) -> Dict:
    """The audit's table (or JSON) at the given rates: each stage's floor is
    the larger of its FLOPs over the rate of its kind (convolution stages:
    dpt_head, alignnet, hsa, lift_fusion) and its bytes over `gbps`."""
    stages = audit_stages(cfg)
    conv_stages = {"dpt_head", "alignnet", "hsa", "lift_fusion"}
    rows = []
    tot_f = tot_b = tot_ms = 0.0
    for s in stages:
        rate = tf_rate_conv if s.name in conv_stages else tf_rate_matmul
        ms = s.ms_floor(rate, gbps)
        rows.append({"stage": s.name, "gflop": round(s.flops / 1e9, 1),
                     "mb_min": round(s.bytes_min / 1e6, 1),
                     "rate_tfs": rate, "ms_floor": round(ms, 3),
                     "note": s.note})
        tot_f += s.flops
        tot_b += s.bytes_min
        tot_ms += ms
    out = {"stages": rows, "total_gflop": round(tot_f / 1e9, 1),
           "total_mb_min": round(tot_b / 1e6, 1),
           "floor_ms": round(tot_ms, 3),
           "ceiling_fps": round(1000.0 / tot_ms, 2),
           "rates": {"matmul_tfs": tf_rate_matmul, "conv_tfs": tf_rate_conv,
                     "hbm_gbps": gbps, "source": "rates given" if (
                         tf_rate_matmul, tf_rate_conv, gbps) != (
                         H100_BF16_TFS, H100_BF16_TFS, H100_HBM_GBPS)
                     else "NVIDIA H100 SXM data-sheet peaks"}}
    if as_json:
        print(json.dumps(out, indent=2))
    else:
        print(f"{'stage':<18}{'GFLOP':>9}{'MB_min':>9}{'TF/s':>7}{'ms_floor':>10}  note")
        for r in rows:
            print(f"{r['stage']:<18}{r['gflop']:>9}{r['mb_min']:>9}"
                  f"{r['rate_tfs']:>7}{r['ms_floor']:>10}  {r['note']}")
        print(f"\ntotal: {out['total_gflop']} GFLOP, {out['total_mb_min']} MB min"
              f" -> floor {out['floor_ms']} ms = ceiling {out['ceiling_fps']} fps"
              f" at ({tf_rate_matmul} TF/s matmul, {tf_rate_conv} TF/s conv,"
              f" {gbps} GB/s: {out['rates']['source']})")
    return out


def main(argv=None):
    import argparse

    from ..configs import presets

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="veon_b")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--matmul-tfs", type=float, default=H100_BF16_TFS)
    ap.add_argument("--conv-tfs", type=float, default=H100_BF16_TFS)
    ap.add_argument("--gbps", type=float, default=H100_HBM_GBPS)
    args = ap.parse_args(argv)
    cfg = getattr(presets, args.preset)()
    return print_audit(cfg, args.matmul_tfs, args.conv_tfs, args.gbps, args.json)


if __name__ == "__main__":
    main()
