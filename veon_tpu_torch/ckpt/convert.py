"""The reference's PyTorch checkpoints -> the parameter tree of the JAX
model (counterpart of `veon_tpu/ckpt/convert.py`, the same functions and
layout rules, without JAX).

The five checkpoint dialects (open_clip CLIP, detectron2 SAN, the timm
side ViT, DINOv2 with LoRA + DPT, ZoeDepth-NK on MiDaS BEiT with LoRA)
in the reference's dual-checkpoint
convention: a SAN/VEON semantic dump (`--load-from`, keys after the
`semantic_model.model.` strip) and a depth dump (`--depth-load-from`).

Inputs are plain {str: np.ndarray} state dicts (`load_torch_state_dict`
reads a .pth). Outputs are the flax-named nested numpy trees of the JAX
model, scan stacks included, so `ckpt/from_jax.py` maps them onto the port
as it maps JAX variables, and a conversion equals the JAX converter's leaf
for leaf. Layout rules:
  Linear (out,in) -> kernel (in,out);     Conv2d (o,i,kh,kw) -> (kh,kw,i,o)
  Conv3d (o,i,kd,kh,kw) -> (kd,kh,kw,i,o); ConvT2d (i,o,kh,kw) -> (kh,kw,i,o),
                                           spatially flipped (flipped back
                                           by `from_jax.py`)
  LayerNorm weight/bias -> scale/bias;    BN running stats -> batch_stats
  MHA in_proj_weight (3E,E) -> (E,3E);    LoRA A (r,in)->(in,r), B (o,r)->(r,o)
The port's depth towers carry no adapters: `merge_lora` folds a depth-
pretrain dump's into the base kernels (scale lora_alpha / r).

`revise_keys`, `merge_params` and `fuse_conv_bn` are the JAX module's
counterparts, held equal to them by `tests/test_torch_convert.py`. The
port merges converted semantic families into a seeded model with
`from_jax.load_families` (`cli/main.py` `checkpoint_model`); `merge_params`
merges a depth dump over the seeded stage-1 tower (`cmd_pretrain_depth`)
and the SAN families here; `fuse_conv_bn` folds the BatchNorms for `test
--fuse-conv-bn` (`cli/main.py` `fuse_model_conv_bn`); `revise_keys` has no
caller in the port.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import DepthConfig, SANConfig, VeonConfig, ZoeConfig

SD = Dict[str, np.ndarray]


def load_torch_state_dict(path: str) -> SD:
    """Load a .pth into numpy, unwrapping {'state_dict': ...} and
    {'model': ...} containers (the convention of the reference's
    tools/misc/process_san_pth.py). Like the reference it unpickles the
    whole file (weights_only=False): load only checkpoints you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "cpu")}


def revise_keys(sd: SD, rules: Sequence[Tuple[str, str]]) -> SD:
    """Regex key remapping (mmcv load_checkpoint revise_keys semantics)."""
    out = sd
    for pat, repl in rules:
        out = {re.sub(pat, repl, k): v for k, v in out.items()}
    return out


# ---------------------------------------------------------------- helpers


def _j(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name

def _lin(sd, key):
    w = sd[_j(key, "weight")].T
    out = {"kernel": w}
    if _j(key, "bias") in sd:
        out["bias"] = sd[_j(key, "bias")]
    return out


def _lora_lin(sd, key):
    out = {"base": _lin(sd, key)}
    if _j(key, "lora_A") in sd:
        out["lora_A"] = sd[_j(key, "lora_A")].T
        out["lora_B"] = sd[_j(key, "lora_B")].T
    return out


def _ln(sd, key):
    return {"scale": sd[_j(key, "weight")], "bias": sd[_j(key, "bias")]}


def _conv2d(sd, key, bias=None):
    w = sd[_j(key, "weight")].transpose(2, 3, 1, 0)
    out = {"kernel": w}
    if _j(key, "bias") in sd and bias is not False:
        out["bias"] = sd[_j(key, "bias")]
    return out


def _conv3d(sd, key):
    w = sd[_j(key, "weight")].transpose(2, 3, 4, 1, 0)
    out = {"kernel": w}
    if _j(key, "bias") in sd:
        out["bias"] = sd[_j(key, "bias")]
    return out


def _convT2d(sd, key):
    # flax ConvTranspose applies the kernel un-flipped (gradient-of-conv
    # convention); torch ConvTranspose2d flips — so flip spatial dims here.
    w = sd[_j(key, "weight")].transpose(2, 3, 0, 1)[::-1, ::-1].copy()
    out = {"kernel": w}
    if _j(key, "bias") in sd:
        out["bias"] = sd[_j(key, "bias")]
    return out


def _bn(sd, key):
    params = {"scale": sd[_j(key, "weight")], "bias": sd[_j(key, "bias")]}
    stats = {"mean": sd[_j(key, "running_mean")], "var": sd[_j(key, "running_var")]}
    return params, stats


def _mha(sd, key):
    """torch nn.MultiheadAttention -> FusedQKVAttention."""
    return {
        "in_proj": {"kernel": sd[_j(key, "in_proj_weight")].T,
                    "bias": sd[_j(key, "in_proj_bias")]},
        "out_proj": _lin(sd, _j(key, "out_proj")),
    }


def _clip_block(sd, key):
    """open_clip ResidualAttentionBlock -> CLIPBlock params."""
    return {
        "ln_1": _ln(sd, _j(key, "ln_1")),
        "attn": _mha(sd, _j(key, "attn")),
        "ln_2": _ln(sd, _j(key, "ln_2")),
        "mlp": {"fc1": {"base": _lin(sd, _j(key, "mlp.c_fc"))},
                "fc2": {"base": _lin(sd, _j(key, "mlp.c_proj"))}},
    }


def _stack(blocks: List[Dict]) -> Dict:
    """Stack per-layer param trees along a new leading axis (the layout of
    a flax scan stack), node by node: every tree has the same keys."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return np.stack(blocks, axis=0)


def _timm_block(sd, key):
    return {
        "norm1": _ln(sd, _j(key, "norm1")),
        "attn": {"qkv": {"base": _lin(sd, _j(key, "attn.qkv"))},
                 "proj": {"base": _lin(sd, _j(key, "attn.proj"))}},
        "norm2": _ln(sd, _j(key, "norm2")),
        "mlp": {"fc1": {"base": _lin(sd, _j(key, "mlp.fc1"))},
                "fc2": {"base": _lin(sd, _j(key, "mlp.fc2"))}},
    }


def _dino_block(sd, key):
    return {
        "norm1": _ln(sd, _j(key, "norm1")),
        "attn": {"qkv": _lora_lin(sd, _j(key, "attn.qkv")),
                 "proj": _lora_lin(sd, _j(key, "attn.proj"))},
        "ls1_gamma": sd[_j(key, "ls1.gamma")],
        "norm2": _ln(sd, _j(key, "norm2")),
        "mlp": {"fc1": _lora_lin(sd, _j(key, "mlp.fc1")),
                "fc2": _lora_lin(sd, _j(key, "mlp.fc2"))},
        "ls2_gamma": sd[_j(key, "ls2.gamma")],
    }


# ---------------------------------------------------------------- towers

def convert_clip_visual(sd: SD, prefix: str, cfg: SANConfig,
                        save_layers: Sequence[int],
                        resblocks_key: str = "resblocks") -> Dict:
    """open_clip VisionTransformer (shallow trunk) -> CLIPVisualExtractor.

    A SAN/VEON dump stores the FeatureExtractor's sliced ModuleList directly
    as `resblocks` (`clip_utils/visual.py:48-52` — torch slice re-indexes
    from 0); pass resblocks_key="transformer.resblocks" for a raw open_clip
    visual tower instead.
    """
    p = prefix
    out = {
        "conv1": _conv2d(sd, f"{p}conv1", bias=False),
        "class_embedding": sd[f"{p}class_embedding"],
        "positional_embedding": sd[f"{p}positional_embedding"],
        "ln_pre": _ln(sd, f"{p}ln_pre"),
    }
    saves = tuple(sorted(set(save_layers) | {0, cfg.feature_last_layer_idx}))
    for si in range(len(saves) - 1):
        a, b = saves[si], saves[si + 1]
        blocks = [_clip_block(sd, f"{p}{resblocks_key}.{i}") for i in range(a, b)]
        out[f"segment_{a}_{b}"] = {"blocks": {"block": _stack(blocks)}}
    return out


def convert_rec_head(sd: SD, prefix: str, cfg: SANConfig,
                     layer_offset: int = 0, resblocks_key: str = "resblocks") -> Dict:
    """open_clip deep trunk + ln_post + proj -> CLIPRecHead (stacked scan).

    From a raw open_clip visual tower use
    layer_offset=cfg.feature_last_layer_idx, resblocks_key="transformer.resblocks";
    a SAN dump's clip_rec_head re-indexes the sliced ModuleList from 0.
    """
    p = prefix
    n = cfg.clip_layers - cfg.feature_last_layer_idx
    blocks = [
        _clip_block(sd, f"{p}{resblocks_key}.{layer_offset + i}") for i in range(n)
    ]
    return {
        "resblocks": {"block": _stack(blocks)},
        "ln_post": _ln(sd, f"{p}ln_post"),
        "proj_kernel": sd[f"{p}proj"],
    }


def convert_text_tower(sd: SD, prefix: str, cfg: SANConfig) -> Dict:
    """open_clip text transformer -> CLIPTextEncoder (stacked scan)."""
    p = prefix
    blocks = [_clip_block(sd, f"{p}transformer.resblocks.{i}")
              for i in range(cfg.text_layers)]
    return {
        "token_embedding": {"embedding": sd[f"{p}token_embedding.weight"]},
        "positional_embedding": sd[f"{p}positional_embedding"],
        "resblocks": {"block": _stack(blocks)},
        "ln_final": _ln(sd, f"{p}ln_final"),
        "text_projection": sd[f"{p}text_projection"],
    }


def convert_side_adapter(sd: SD, prefix: str, cfg: SANConfig) -> Dict:
    """RegionwiseSideAdapterNetwork (timm ViT + fusion + mask decoder)."""
    p = prefix
    out = {
        "patch_embed": _conv2d(sd, f"{p}vit_model.patch_embed.proj"),
        "pos_embed": sd[f"{p}vit_model.pos_embed"][0],
        "query_embed": sd[f"{p}query_embed"][0],
        "query_pos_embed": sd[f"{p}query_pos_embed"][0],
    }

    def fusion_params(blk_idx):
        fk = f"{p}fusion_layers.layer_{blk_idx}"
        return {
            "ln": {"scale": sd[f"{fk}.input_proj.0.weight"],
                   "bias": sd[f"{fk}.input_proj.0.bias"]},
            "proj": {"kernel": sd[f"{fk}.input_proj.1.weight"][:, :, 0, 0].T,
                     "bias": sd[f"{fk}.input_proj.1.bias"]},
        }

    out["fusion_layer_0"] = fusion_params(0)
    n_fused = len(cfg.fusion_map) - 1
    out["fused_blocks"] = {
        "block": _stack([_timm_block(sd, f"{p}vit_model.blocks.{i}")
                         for i in range(n_fused)]),
        "fusion": _stack([fusion_params(i + 1) for i in range(n_fused)]),
    }
    n_plain = cfg.side_depth - n_fused - 1
    if n_plain > 0:
        out["plain_blocks"] = {
            "block": _stack([_timm_block(sd, f"{p}vit_model.blocks.{i}")
                             for i in range(n_fused, n_fused + n_plain)])
        }
    out["last_block"] = _timm_block(sd, f"{p}vit_model.blocks.{cfg.side_depth - 1}")
    md = f"{p}mask_decoder"
    dec: Dict[str, Any] = {}
    for branch, conv in (("query_mlp", False), ("pix_mlp", True), ("attn_mlp", True)):
        layers = {}
        for i in range(cfg.attn_bias_mlp_num_layers):
            key = f"{md}.{branch}.layers.{i}"
            if conv:
                layers[f"layers_{i}"] = {
                    "kernel": sd[_j(key, "weight")][:, :, 0, 0].T,
                    "bias": sd[_j(key, "bias")],
                }
            else:
                layers[f"layers_{i}"] = _lin(sd, key)
        dec[branch] = layers
    if cfg.rescale_attn_bias:
        dec["bias_scaling_w"] = sd[f"{md}.bias_scaling.weight"].reshape(())
        dec["bias_scaling_b"] = sd[f"{md}.bias_scaling.bias"].reshape(())
    out["mask_decoder"] = dec
    return out


def convert_hsa(sd: SD, prefix: str, cfg) -> Dict:
    """HighresSideAdaptorNetwork -> HighresSideAdaptor."""
    p = prefix
    out = {"patch_embed": _conv2d(sd, f"{p}patch_embed.proj")}

    def conv_ffn(key):
        return {
            "conv1": _conv2d(sd, f"{key}.conv1"),
            "ln1": _ln(sd, f"{key}.ln1"),
            "conv2": _conv2d(sd, f"{key}.conv2"),
            "ln2": _ln(sd, f"{key}.ln2"),
        }

    blocks = []
    for i in range(len(cfg.fusion_map)):
        k = f"{p}hsa_net_body.{i}"
        blocks.append({
            "ln_3": _ln(sd, f"{k}.ln_3"),
            "ff": conv_ffn(f"{k}.ff"),
            "ln_4": _ln(sd, f"{k}.ln_4"),
            "neck_add": {"kernel": sd[f"{k}.neck_add.weight"].T},
        })
    out["pre_norm"] = _ln(sd, f"{p}hsa_net_body.0.pre_norm")
    out["hsa_blocks"] = {"block": _stack(blocks)}

    def ff_head(key):
        return {
            "ln": _ln(sd, f"{key}.net.0"),
            "fc1": _lin(sd, f"{key}.net.1"),
            "fc2": _lin(sd, f"{key}.net.3"),
        }

    r = f"{p}rear_block"
    out["rear_block"] = {
        "ln_3": _ln(sd, f"{r}.ln_3"),
        "ff": conv_ffn(f"{r}.ff"),
        "ln_4": _ln(sd, f"{r}.ln_4"),
        "head_attn": ff_head(f"{r}.head_attn"),
        "head_supp": ff_head(f"{r}.head_supp"),
    }
    return out


def convert_alignnet(sd: SD, prefix: str, cfg) -> Tuple[Dict, Dict]:
    """AlignNetOcc3D 3D stack + heads -> (params, batch_stats).

    The lift fusion layer (fusion_layers.layer_0) converts separately into
    the model's lift_fusion module. Temporal-fusion weights
    (`align_net_occ3d.py:13-128`, present when the checkpoint was trained
    with num_temporal > 1) convert when their keys exist.
    """
    p = prefix
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def conv_bn(src, relu_unused=True):
        pr, st = _bn(sd, f"{src}.bn")
        return {"conv": _conv3d(sd, f"{src}.conv"), "bn": pr}, {"bn": st}

    blk_ps, blk_ss = [], []
    for i in range(cfg.layer_depth):
        blk_p, blk_s = {}, {}
        for j in (1, 2):
            cp, cs = conv_bn(f"{p}layers_3d_body.{i}.conv{j}")
            blk_p[f"conv{j}"] = cp
            blk_s[f"conv{j}"] = cs
        blk_ps.append(blk_p)
        blk_ss.append(blk_s)
    params["res3d"] = {"block": _stack(blk_ps)}
    stats["res3d"] = {"block": _stack(blk_ss)}

    op, osd = conv_bn(f"{p}occupancy_pred.occ_conv1")
    params["occupancy_pred"] = {"occ_conv1": op,
                                "occ_conv2": _conv3d(sd, f"{p}occupancy_pred.occ_conv2.conv")}
    stats["occupancy_pred"] = {"occ_conv1": osd}
    fp: Dict[str, Any] = {}
    fs: Dict[str, Any] = {}
    for j in (1, 2):
        cp, cs = conv_bn(f"{p}feat_pred.occ_conv{j}")
        fp[f"occ_conv{j}"] = cp
        fs[f"occ_conv{j}"] = cs
    fp["occ_conv3"] = _conv3d(sd, f"{p}feat_pred.occ_conv3.conv")
    params["feat_pred"] = fp
    stats["feat_pred"] = fs

    if f"{p}temporal_fusion.t_final.conv.weight" in sd:
        tp, ts = _convert_temporal_fusion(sd, f"{p}temporal_fusion.", conv_bn)
        params["temporal_fusion"] = tp
        stats["temporal_fusion"] = ts
    return params, stats


def _convert_temporal_fusion(sd: SD, p: str, conv_bn) -> Tuple[Dict, Dict]:
    """TemporalFusionMultiFrame (`align_net_occ3d.py:13-128`) ->
    nn.alignnet.TemporalFusion (+ TemporalDeformable)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["before_fusion"], stats["before_fusion"] = conv_bn(
        f"{p}before_fusion_layer.offset_conv")
    i = 0
    while f"{p}t_fuse_mid.t_fuse.{i}.conv.weight" in sd:
        params[f"t_fuse_{i}"], stats[f"t_fuse_{i}"] = conv_bn(
            f"{p}t_fuse_mid.t_fuse.{i}")
        i += 1
    params["t_final"], stats["t_final"] = conv_bn(f"{p}t_final")
    d = f"{p}deform_fusion_layer.t_deform."
    dn_p, dn_s = _bn(sd, f"{d}final_norm")
    params["t_deform"] = {
        "offset_conv1": _conv3d(sd, f"{d}offset_conv.0"),
        "offset_conv2": _conv3d(sd, f"{d}offset_conv.2"),
        "key_value_proj": _conv3d(sd, f"{d}key_value_proj"),
        "query_proj": _conv3d(sd, f"{d}query_proj"),
        "out_proj": _conv3d(sd, f"{d}out_proj"),
        "final_norm": dn_p,
    }
    stats["t_deform"] = {"final_norm": dn_s}
    return params, stats


def merge_params(dst: Dict, src: Dict) -> Dict:
    """Deep-merge a converted (possibly partial) param tree over the model's
    init tree: leaves present in src replace dst's, leaves absent in src keep
    their init values (e.g. LoRA adapters when loading a LoRA-free release
    dump into a use_lora model). Raises on keys src has that dst lacks —
    that is layout drift, not a partial checkpoint."""
    out = dict(dst)
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), Mapping):
            out[k] = merge_params(out[k], v)
        else:
            if k not in out:
                raise KeyError(
                    f"converted checkpoint has '{k}' but the model tree does "
                    f"not (available: {sorted(out)[:8]}...)")
            if isinstance(v, Mapping) != isinstance(out[k], Mapping):
                raise KeyError(
                    f"layout drift at '{k}': checkpoint has "
                    f"{'a subtree' if isinstance(v, Mapping) else 'a leaf'} "
                    f"but the model tree has the opposite")
            out[k] = v
    return out


def convert_lift_fusion(sd: SD, prefix: str) -> Dict:
    """CatFusionLift (layers.py:154-199) -> LiftFusion."""
    p = f"{prefix}fusion_layers.layer_0"

    def proj(key):
        return {
            "kernel": sd[f"{key}.1.weight"][:, :, 0, 0].T,
            "bias": sd[f"{key}.1.bias"],
        }

    def ln(key):
        return {"scale": sd[f"{key}.0.weight"], "bias": sd[f"{key}.0.bias"]}

    return {"fusion_layer_0": {
        "ln1": ln(f"{p}.input_proj_1"), "proj1": proj(f"{p}.input_proj_1"),
        "ln2": ln(f"{p}.input_proj_2"), "proj2": proj(f"{p}.input_proj_2"),
    }}


def convert_dav2(sd: SD, cfg: DepthConfig) -> Dict:
    """DepthAnythingV2Adaptor -> DepthAnythingV2 (trunk + DPT head)."""
    trunk: Dict[str, Any] = {
        "patch_embed": _conv2d(sd, "pretrained.patch_embed.proj"),
        "cls_token": sd["pretrained.cls_token"],
        "pos_embed": sd["pretrained.pos_embed"][0],
        "norm": _ln(sd, "pretrained.norm"),
    }
    bounds = [0] + [t + 1 for t in sorted(cfg.intermediate_layer_idx)]
    for si in range(len(bounds) - 1):
        a, b = bounds[si], bounds[si + 1]
        blocks = [_dino_block(sd, f"pretrained.blocks.{i}") for i in range(a, b)]
        trunk[f"segment_{a}_{b}"] = {"blocks": {"block": _stack(blocks)}}

    head: Dict[str, Any] = {}
    for i in range(4):
        head[f"projects_{i}"] = _conv2d(sd, f"depth_head.projects.{i}")
    head["resize_0"] = _convT2d(sd, "depth_head.resize_layers.0")
    head["resize_1"] = _convT2d(sd, "depth_head.resize_layers.1")
    head["resize_3"] = _conv2d(sd, "depth_head.resize_layers.3")
    for i in range(4):
        head[f"layer{i + 1}_rn"] = _conv2d(sd, f"depth_head.scratch.layer{i + 1}_rn",
                                           bias=False)
    for i in (1, 2, 3, 4):
        rk = f"depth_head.scratch.refinenet{i}"
        head[f"refinenet{i}"] = {
            "rcu2": {"conv1": _conv2d(sd, f"{rk}.resConfUnit2.conv1"),
                     "conv2": _conv2d(sd, f"{rk}.resConfUnit2.conv2")},
            "out_conv": _conv2d(sd, f"{rk}.out_conv"),
        }
        if i != 4:
            # the top fusion block has no skip input, so its resConfUnit1
            # exists in dumps but is never used by the forward (dead weights)
            head[f"refinenet{i}"]["rcu1"] = {
                "conv1": _conv2d(sd, f"{rk}.resConfUnit1.conv1"),
                "conv2": _conv2d(sd, f"{rk}.resConfUnit1.conv2")}
    head["output_conv1"] = _conv2d(sd, "depth_head.scratch.output_conv1")
    head["output_conv2_0"] = _conv2d(sd, "depth_head.scratch.output_conv2.0")
    head["output_conv2_2"] = _conv2d(sd, "depth_head.scratch.output_conv2.2")
    return {"pretrained": trunk, "depth_head": head}


def _beit_block(sd, key):
    """timm BEiT block (MiDaS backbone) -> nn.zoedepth.BeitBlock params;
    the buffer relative_position_index is not read (the port computes it)."""
    return {
        "norm1": _ln(sd, _j(key, "norm1")),
        "attn": {
            "qkv": _lora_lin(sd, _j(key, "attn.qkv")),
            "proj": _lin(sd, _j(key, "attn.proj")),
            "q_bias": sd[_j(key, "attn.q_bias")],
            "v_bias": sd[_j(key, "attn.v_bias")],
            "relative_position_bias_table": sd[_j(key, "attn.relative_position_bias_table")],
        },
        "gamma_1": sd[_j(key, "gamma_1")],
        "norm2": _ln(sd, _j(key, "norm2")),
        "mlp_fc1": _lin(sd, _j(key, "mlp.fc1")),
        "mlp_fc2": _lin(sd, _j(key, "mlp.fc2")),
        "gamma_2": sd[_j(key, "gamma_2")],
    }


def convert_zoedepth(sd: SD, cfg: ZoeConfig) -> Dict:
    """ZoeDepthNKAdaptor state dict -> nn.zoedepth.ZoeDepthNK params.

    Torch layout (zoedepth_nk_v1.py): core.core.pretrained.model.* (timm
    BEiT), core.core.pretrained.act_postprocessN (readout + resize),
    core.core.scratch.* (RN convs, refinenets, output_conv), conv2,
    seed_bin_regressors.kitti, seed_projector, projectors.N,
    attractors.kitti.N, conditional_log_binomial.kitti.
    """
    p = "core.core.pretrained.model."
    trunk: Dict[str, Any] = {
        "patch_embed": _conv2d(sd, f"{p}patch_embed.proj"),
        "cls_token": sd[f"{p}cls_token"],
    }
    for i in range(cfg.depth):
        trunk[f"blocks_{i}"] = _beit_block(sd, f"{p}blocks.{i}")

    core: Dict[str, Any] = {"pretrained": trunk}
    ap = "core.core.pretrained."
    for i in range(4):
        core[f"readout_{i}"] = {
            "project": _lora_lin(sd, f"{ap}act_postprocess{i + 1}.0.project.0")}
        core[f"project_{i}"] = _conv2d(sd, f"{ap}act_postprocess{i + 1}.3")
    core["resize_0"] = _convT2d(sd, f"{ap}act_postprocess1.4")
    core["resize_1"] = _convT2d(sd, f"{ap}act_postprocess2.4")
    core["resize_3"] = _conv2d(sd, f"{ap}act_postprocess4.4")
    sc = "core.core.scratch."
    for i in range(4):
        core[f"layer{i + 1}_rn"] = _conv2d(sd, f"{sc}layer{i + 1}_rn", bias=False)
    for i in (1, 2, 3, 4):
        rk = f"{sc}refinenet{i}"
        core[f"refinenet{i}"] = {
            "rcu2": {"conv1": _conv2d(sd, f"{rk}.resConfUnit2.conv1"),
                     "conv2": _conv2d(sd, f"{rk}.resConfUnit2.conv2")},
            "out_conv": _conv2d(sd, f"{rk}.out_conv"),
        }
        if i != 4:  # refinenet4's resConfUnit1 is dead weight (no skip input)
            core[f"refinenet{i}"]["rcu1"] = {
                "conv1": _conv2d(sd, f"{rk}.resConfUnit1.conv1"),
                "conv2": _conv2d(sd, f"{rk}.resConfUnit1.conv2")}
    core["out_conv1"] = _conv2d(sd, f"{sc}output_conv.0")
    core["out_conv2"] = _conv2d(sd, f"{sc}output_conv.2")
    core["out_conv3"] = _conv2d(sd, f"{sc}output_conv.4")

    def conv_mlp(key):
        return {"fc1": _conv2d(sd, f"{key}.0"), "fc2": _conv2d(sd, f"{key}.2")}

    out: Dict[str, Any] = {
        "core": core,
        "conv2": _conv2d(sd, "conv2"),
        "seed_bin_regressor": conv_mlp("seed_bin_regressors.kitti._net"),
        "seed_projector": conv_mlp("seed_projector._net"),
        "clb_fc1": _conv2d(sd, "conditional_log_binomial.kitti.mlp.0"),
        "clb_fc2": _conv2d(sd, "conditional_log_binomial.kitti.mlp.2"),
    }
    for i in range(4):
        out[f"projector_{i}"] = conv_mlp(f"projectors.{i}._net")
        out[f"attractor_{i}"] = conv_mlp(f"attractors.kitti.{i}._net")
    return out


def convert_san_semantic(sd: SD, cfg: VeonConfig) -> Tuple[Dict, Dict, Dict]:
    """A full SAN/VEON semantic checkpoint (SANInVeonTemporal layout) ->
    (model params subtrees, batch_stats, text-side extras).

    Handles both a raw SAN release (prefixes like clip_visual_extractor.)
    and a trained VEON checkpoint with the `semantic_model.model.` prefix
    already stripped via revise_keys.
    """
    save_layers = tuple(sorted(
        {cl for _, cl in cfg.san.fusion_map}
        | {ca for _, ca, _ad in cfg.hsa.fusion_map}
        | {ad for _, _ca, ad in cfg.hsa.fusion_map}
        | {cfg.san.feature_last_layer_idx}
    ))
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["clip_visual"] = convert_clip_visual(
        sd, "clip_visual_extractor.", cfg.san, save_layers
    )
    params["rec_head"] = convert_rec_head(sd, "clip_rec_head.", cfg.san)
    params["side_adapter"] = convert_side_adapter(sd, "side_adapter_network.", cfg.san)
    params["hsa"] = convert_hsa(sd, "highres_side_adaptor_network.", cfg.hsa)
    align_p, align_s = convert_alignnet(sd, "occ_decoder.", cfg.propagation)
    params["alignnet"] = align_p
    stats["alignnet"] = align_s
    params["lift_fusion"] = convert_lift_fusion(sd, "occ_decoder.")

    extras: Dict[str, Any] = {}
    if "ov_classifier.logit_scale" in sd:
        extras["logit_scale"] = sd["ov_classifier.logit_scale"]
    if "ov_classifier.bg_embed" in sd:
        extras["bg_embed"] = sd["ov_classifier.bg_embed"]
    if "ov_classifier.token_embedding.weight" in sd:
        extras["text_tower"] = convert_text_tower(sd, "ov_classifier.", cfg.san)
    return params, stats, extras


def merge_lora(params: Dict, lora_alpha: float = 1.0) -> Dict:
    """Fold LoRA adapters into base kernels for inference: W' = W + s*A@B
    with s = alpha/r — mathematically identical to the adapter forward
    (lora_layers.py merge_weights semantics), removing the extra matmuls.
    Returns a tree matching the lora_r=0 module layout."""

    def walk(node):
        if isinstance(node, dict):
            if "base" in node and "lora_A" in node:
                a = np.asarray(node["lora_A"])
                b = np.asarray(node["lora_B"])
                r = a.shape[-1]
                base = dict(node["base"])
                base["kernel"] = np.asarray(base["kernel"]) + (lora_alpha / r) * (a @ b)
                return {"base": base}
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def fuse_conv_bn(params: Dict, batch_stats: Dict,
                 eps: float = 1e-5) -> Tuple[Dict, Dict]:
    """Eval-time Conv+BN folding (`tools/test.py --fuse-conv-bn`).

    Wherever a param subtree holds sibling {conv, bn} (our ConvBN3D layout)
    with matching batch stats, scale the conv kernel by s/sqrt(v+eps) per
    out-channel and neutralize the BN's normalization (mean=0, var=1-eps,
    scale=1), keeping the whole additive term in the BN bias — the tree
    structure is unchanged (no bias key is added to bias-free convs), and
    the unchanged model graph computes exactly the same function:
    y = s*(conv(x)+b0-mu)/sqrt(v+eps) + t == conv_k'(x) + (b0-mu)*g + t.
    Returns new (params, batch_stats) trees.
    """

    def walk(p, s):
        if not isinstance(p, dict):
            return p, s
        if ("conv" in p and "bn" in p and isinstance(s, dict)
                and "bn" in s and "kernel" in p.get("conv", {})):
            k = np.asarray(p["conv"]["kernel"])
            b0 = np.asarray(p["conv"].get("bias", np.zeros(k.shape[-1], k.dtype)))
            scale = np.asarray(p["bn"]["scale"])
            bias = np.asarray(p["bn"]["bias"])
            mu = np.asarray(s["bn"]["mean"])
            var = np.asarray(s["bn"]["var"])
            g = scale / np.sqrt(var + eps)
            # broadcast over spatial/in-channel dims; leading dims (if any)
            # are nn.scan stack axes shared by kernel and bn
            g_k = g.reshape(g.shape[:-1] + (1,) * (k.ndim - g.ndim) + g.shape[-1:])
            new_p = dict(p)
            new_conv = {"kernel": (k * g_k).astype(k.dtype)}
            if "bias" in p["conv"]:
                new_conv["bias"] = np.zeros_like(b0)
            new_p["conv"] = new_conv
            new_p["bn"] = {"scale": np.ones_like(scale),
                           "bias": ((b0 - mu) * g + bias).astype(bias.dtype)}
            new_s = dict(s)
            new_s["bn"] = {"mean": np.zeros_like(mu),
                           "var": np.full_like(var, 1.0 - eps)}
            # keep walking the node's OTHER children: a layout that nests
            # further conv/bn pairs under a fused node must still be folded
            for key, v in p.items():
                sub_s = new_s.get(key)
                if key not in ("conv", "bn") and isinstance(v, dict) \
                        and isinstance(sub_s, dict):
                    new_p[key], new_s[key] = walk(v, sub_s)
            return new_p, new_s
        out_p, out_s = dict(p), dict(s) if isinstance(s, dict) else s
        for key, v in p.items():
            sub_s = s.get(key) if isinstance(s, dict) else None
            if isinstance(v, dict) and isinstance(sub_s, dict):
                out_p[key], out_s[key] = walk(v, sub_s)
        return out_p, out_s

    return walk(dict(params), dict(batch_stats))
