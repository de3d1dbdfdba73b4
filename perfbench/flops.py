"""The benchmark's analytic work counts, from a configuration's shapes, so
they read the same work whatever implements it.

`serving_stages` is a copy of the port's `utils/roofline.py`
`audit_stages` (the single-frame serving graph, stage for stage:
forward multiply-adds x 2, least bytes), with the ZoeDepth-NK tower in
place of DA-V2 where the configuration has it. `temporal_stages` adds a
streaming call's temporal fusion and warp; `per_request` gives a served
request's FLOPs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


def transformer_layer(L: int, C: int, mlp_ratio: float = 4.0,
                      extra_qk: int = 0, cross_q: int = 0) -> Tuple[float, float]:
    """(flops, bytes_min) of one ViT encoder layer on L tokens of width C.
    extra_qk: augmented qk channels (HSA's factorized bias fusion);
    cross_q: extra cross-attention query tokens (the rec head's sos)."""
    d = C + extra_qk
    flops = (6 * L * C * C + 2 * L * L * d + 2 * L * L * C + 2 * L * C * C
             + 2 * 2 * L * C * (mlp_ratio * C))
    if cross_q:
        flops += (6 * cross_q * C * C + 2 * cross_q * L * d + 2 * cross_q * L * C
                  + 2 * cross_q * C * C + 4 * cross_q * C * (mlp_ratio * C))
    return flops, 2 * (2 * L * C) + 4 * 2 * L * L


def transformer_params(C: int, mlp_ratio: float = 4.0) -> float:
    return 2 * (4 * C * C + 2 * mlp_ratio * C * C)


def conv2d(H: int, W: int, cin: int, cout: int, k: int = 3, stride: int = 1):
    ho, wo = H // stride, W // stride
    return 2 * ho * wo * k * k * cin * cout, 2 * (H * W * cin + ho * wo * cout)


def conv3d(Z: int, Y: int, X: int, cin: int, cout: int, k: int = 3):
    return (2 * Z * Y * X * k ** 3 * cin * cout,
            2 * (Z * Y * X * (cin + cout)) + 2 * k ** 3 * cin * cout)


@dataclasses.dataclass
class Stage:
    name: str
    flops: float
    bytes_min: float


def _dav2_size(h: int, w: int, target: int) -> Tuple[int, int]:
    import numpy as np

    def constrain(x: float) -> int:
        y = int(np.round(x / 14) * 14)
        return y if y >= target else int(np.ceil(x / 14) * 14)

    scale = max(target / h, target / w)
    return constrain(scale * h), constrain(scale * w)


def _dav2_stages(cfg, N: int) -> List[Stage]:
    H, W = cfg.data.input_size
    dh, dw = _dav2_size(H, W, cfg.data.dav2_target)
    vit = cfg.depth.vit
    ph, pw = dh // 14, dw // 14
    Ld = ph * pw + 1
    f = b = 0.0
    for _ in range(vit.depth):
        fl, by = transformer_layer(Ld, vit.width)
        f += fl * N
        b += by * N
    f += 2 * ph * pw * (14 * 14 * 3) * vit.width * N
    b += vit.depth * transformer_params(vit.width)
    out = [Stage("depth_trunk", f, b)]
    f = b = 0.0
    oc, feat = cfg.depth.out_channels, cfg.depth.features

    def add(fl_by):
        nonlocal f, b
        f += fl_by[0] * N
        b += fl_by[1] * N

    for c in oc:
        add(conv2d(ph, pw, vit.width, c, k=1))
    add(conv2d(ph * 4, pw * 4, oc[0], oc[0], k=1))
    add(conv2d(ph * 2, pw * 2, oc[1], oc[1], k=1))
    add(conv2d(ph, pw, oc[3], oc[3], k=3, stride=2))
    for i, s in enumerate([4, 2, 1, 0.5]):
        add(conv2d(int(ph * s), int(pw * s), oc[i], feat, k=3))
    for s in [1, 2, 4, 8]:
        hh, ww = ph * s, pw * s
        for _ in range(4):
            add(conv2d(hh, ww, feat, feat, k=3))
        add(conv2d(hh * 2, ww * 2, feat, feat, k=1))
    add(conv2d(ph * 8, pw * 8, feat, feat // 2, k=3))
    add(conv2d(ph * 14, pw * 14, feat // 2, 32, k=3))
    b += 2 * 25e6
    out.append(Stage("dpt_head", f, b))
    return out


def _zoe_stages(cfg, N: int) -> List[Stage]:
    """The ZoeDepth-NK tower (`nn/zoedepth.py`): the BEiT-L trunk on the
    depth input, the MiDaS decoder (readouts, projections, the resize
    pyramid, RN convs, the refinenet cascade, the output convs) and the
    metric-bins head (seed and per-level projector / attractor MLPs, the
    conditional log-binomial head)."""
    z = cfg.zoe
    dh, dw = cfg.data.depth_input_size
    ph, pw = dh // z.patch_size, dw // z.patch_size
    L = ph * pw + 1
    C, pc, feat, E = z.width, z.pyramid_channels, z.features, z.bin_embedding_dim
    f = b = 0.0
    for _ in range(z.depth):
        fl, by = transformer_layer(L, C)
        f += fl * N
        b += by * N
    f += 2 * ph * pw * (z.patch_size ** 2 * 3) * C * N
    b += z.depth * transformer_params(C)
    out = [Stage("depth_trunk", f, b)]
    f = b = 0.0

    def add(fl_by):
        nonlocal f, b
        f += fl_by[0] * N
        b += fl_by[1] * N

    sizes = [(ph * 4, pw * 4), (ph * 2, pw * 2), (ph, pw), (ph // 2, pw // 2)]
    for i in range(4):
        f += 2 * (L - 1) * 2 * C * C * N  # readout: Dense(2C -> C) on the patch tokens
        add(conv2d(ph, pw, C, pc[i], k=1))
    f += 2 * ph * pw * 16 * pc[0] * pc[0] * N  # resize_0: transposed conv, stride 4
    f += 2 * ph * pw * 4 * pc[1] * pc[1] * N  # resize_1: transposed conv, stride 2
    add(conv2d(ph, pw, pc[3], pc[3], k=3, stride=2))
    for i, (hh, ww) in enumerate(sizes):
        add(conv2d(hh, ww, pc[i], feat, k=3))
    for level, (hh, ww) in zip((4, 3, 2, 1), sizes[::-1]):
        for _ in range(2 if level == 4 else 4):  # RCUs: two 3x3 convs each
            add(conv2d(hh, ww, feat, feat, k=3))
        add(conv2d(hh * 2, ww * 2, feat, feat, k=1))
    H1, W1 = sizes[0][0] * 2, sizes[0][1] * 2
    add(conv2d(H1, W1, feat, feat // 2, k=3))
    add(conv2d(H1 * 2, W1 * 2, feat // 2, 32, k=3))
    add(conv2d(H1 * 2, W1 * 2, 32, 1, k=1))
    b += 2 * 25e6
    out.append(Stage("midas_decoder", f, b))
    f = b = 0.0
    hb, wb = sizes[3]
    add(conv2d(hb, wb, feat, feat, k=1))
    f += 2 * hb * wb * (feat * E // 2 * 2 + E // 2 * (z.n_bins + E)) * N
    for i, (hh, ww) in enumerate([(s[0] * 2, s[1] * 2) for s in sizes[::-1]]):
        f += 2 * hh * ww * (feat * E // 2 + E // 2 * E) * N
        f += 2 * hh * ww * (E * E + E * z.n_attractors[i]) * N
    cin = 32 + E
    f += 2 * (H1 * 2) * (W1 * 2) * (cin * (cin // 4) + (cin // 4) * 4) * N
    out.append(Stage("bins_head", f, b))
    return out


def serving_stages(cfg, num_cams: int = 6) -> List[Stage]:
    """Per-stage forward work of the single-frame serving graph
    (`utils/roofline.py` `audit_stages`, the depth tower by branch)."""
    N = num_cams
    H, W = cfg.data.input_size
    stages = _zoe_stages(cfg, N) if cfg.depth_mode == "zoedepth" else _dav2_stages(cfg, N)
    s = cfg.san
    ch, cw = H // 2, W // 2
    gh, gw = ch // s.clip_patch_size, cw // s.clip_patch_size
    Lc = gh * gw + 1
    f = b = 0.0
    for _ in range(s.feature_last_layer_idx):
        fl, by = transformer_layer(Lc, s.clip_width)
        f += fl * N
        b += by * N
    f += 2 * gh * gw * (s.clip_patch_size ** 2 * 3) * s.clip_width * N
    b += s.feature_last_layer_idx * transformer_params(s.clip_width)
    stages.append(Stage("clip_extractor", f, b))

    sh, sw = H // s.side_patch_size, W // s.side_patch_size
    Ls = sh * sw + s.num_queries
    f = b = 0.0
    for _ in range(s.side_depth):
        fl, by = transformer_layer(Ls, s.side_width)
        f += fl * N
        b += by * N
    f += 2 * sh * sw * (s.side_patch_size ** 2 * 3) * s.side_width * N
    for _blk, _cl in s.fusion_map:
        f += 2 * gh * gw * s.clip_width * s.side_width * N
    ab = s.attn_bias_embed_channels
    f += 2 * s.num_queries * s.side_width * ab * 3 * N
    f += 2 * sh * sw * s.side_width * ab * N
    f += 2 * s.num_queries * sh * sw * ab * N * s.attn_bias_heads
    b += s.side_depth * transformer_params(s.side_width)
    stages.append(Stage("side_adapter", f, b))

    n_deep = s.clip_layers - s.feature_last_layer_idx
    f = b = 0.0
    for _ in range(n_deep):
        fl, by = transformer_layer(Lc, s.clip_width, cross_q=s.num_queries)
        f += fl * N
        b += by * N
    b += n_deep * transformer_params(s.clip_width)
    stages.append(Stage("rec_head", f, b))

    hs = cfg.hsa
    hh, hw = H // hs.patch_shape[0], W // hs.patch_shape[1]
    Lh = hh * hw
    d = hs.dim
    f = b = 0.0
    f += 2 * Lh * (hs.patch_shape[0] * hs.patch_shape[1] * 3) * d * N
    for _ in range(len(hs.fusion_map)):
        for _c in range(2):
            fl, by = conv2d(hh, hw, d, hs.mlp_dim, k=3)
            f += fl * N
            b += by * N
        f += 2 * gh * gw * hs.clip_dim * d * N
    for _c in range(2):
        fl, by = conv2d(hh, hw, d, hs.mlp_dim, k=3)
        f += fl * N
        b += by * N
    attn_out = hs.manip_attn_layers * hs.num_heads * hs.manip_dim_head
    f += 2 * Lh * hs.mlp_dim * (hs.mlp_dim + attn_out) * N
    f += 2 * Lh * hs.mlp_dim * (hs.mlp_dim + hs.manip_supp_dim) * N
    b += 8 * 19 * N * Lh * d
    b += 8 * 2 * 9 * hs.mlp_dim * d + 2 * 2 * hs.mlp_dim * (attn_out + hs.manip_supp_dim)
    stages.append(Stage("hsa", f, b))

    f = b = 0.0
    for _ in range(n_deep):
        fl, by = transformer_layer(Lc, s.clip_width, extra_qk=hs.manip_dim_head)
        f += fl * N
        b += by * N
    f += 2 * gh * gw * s.clip_width * s.clip_embed_dim * N
    b += n_deep * transformer_params(s.clip_width)
    stages.append(Stage("deep_clip_rerun", f, b))

    lh, lw = H // cfg.lss_downsample, W // cfg.lss_downsample
    D = cfg.grid.num_depth_bins
    C = cfg.propagation.dim
    rows = int(N * D * lh * lw * 0.58)  # the in-grid share of the rig's points
    nxl, nyl, nzl = cfg.grid.scaled(cfg.lss_feat_ds).size
    stages.append(Stage("lift", 2 * rows * C, 2 * rows * C * 3 + 2 * nxl * nyl * nzl * C))

    f = 2 * lh * lw * (hs.manip_supp_dim + s.clip_width) * C * N
    fl, by = conv2d(lh, lw, C, C, k=3)
    stages.append(Stage("lift_fusion", f + fl * N, by * N))

    f = b = 0.0
    for _ in range(cfg.propagation.layer_depth * 2):
        fl, by = conv3d(nzl, nyl, nxl, C, C, k=3)
        f += fl
        b += by
    mid = C // 4
    for cin, cout in ((C, mid), (mid, 2), (C, C), (C, C), (C, cfg.propagation.clip_proj_dim)):
        fl, by = conv3d(nzl, nyl, nxl, cin, cout, k=1)
        f += fl
        b += by
    stages.append(Stage("alignnet", f, b))

    nx, ny, nz = cfg.grid.size
    V = nx * ny * nz
    n_prompts, cp = 67, cfg.propagation.clip_proj_dim
    stages.append(Stage("output", 2 * V * cp * n_prompts + 8 * V * cp,
                        2 * V * (cp + n_prompts + 2) + 2 * nxl * nyl * nzl * cp))
    return stages


def temporal_stages(cfg, num_prev: int = 1) -> List[Stage]:
    """A streaming call's extra work (`nn/alignnet.py` `TemporalFusion`,
    `model/veon.py` `align_to_prev`) at the pooled grid: `before_fusion`
    on every frame, the t_fuse chain, the deformable attention twice (its
    projections, offset convs and the 27-tap stencil) and `t_final`; the
    trilinear warp of each previous frame."""
    C = cfg.propagation.dim
    nxl, nyl, nzl = cfg.grid.scaled(cfg.lss_feat_ds).size
    V = nxl * nyl * nzl
    f = b = 0.0

    def add(fl_by, times=1):
        nonlocal f, b
        f += fl_by[0] * times
        b += fl_by[1] * times

    add(conv3d(nzl, nyl, nxl, C, C), num_prev + 1)
    add(conv3d(nzl, nyl, nxl, 2 * C, C), num_prev)
    nh, ns = 4, 8
    for _ in range(2):
        add(conv3d(nzl, nyl, nxl, C, 2 * C, k=1))
        add(conv3d(nzl, nyl, nxl, C, C, k=1))
        add(conv3d(nzl, nyl, nxl, C, C))
        add(conv3d(nzl, nyl, nxl, C, nh * ns * 3))
        add(conv3d(nzl, nyl, nxl, C, C, k=1))
        f += 27 * 4 * V * C  # stencil: q.k and the weighted values per tap
    add(conv3d(nzl, nyl, nxl, 3 * C, C))
    fusion = Stage("temporal_fusion", f, b)
    warp = Stage("warp", num_prev * 2 * 8 * V * C, num_prev * 2 * 2 * V * C)
    return [fusion, warp]


def per_request(cfg, num_temporal: int) -> float:
    """FLOPs of one served request: the frame, plus the temporal fusion and
    warp of a streaming call."""
    stages = serving_stages(cfg, cfg.data.num_cams)
    if num_temporal > 1:
        stages += temporal_stages(cfg, num_temporal - 1)
    return sum(s.flops for s in stages)


def per_item(cfg, traffic) -> float:
    """FLOPs per request of a cell's traffic."""
    return per_request(cfg, traffic["num_temporal"])
