"""Reference-layout checkpoint files for the port's weights tests and
`chip_smoke.py`, from the torch mirrors of `tests/ref_layout_mirror.py`
(this module imports no JAX, so the card's machine can use it):

- `spread` gives a mirror state_dict the scales of trained weights (the
  mirrors draw every parameter from N(0, 0.02), so LayerNorm scales near
  0 and the depth head's sigmoid stays near 40 m everywhere, which makes
  the class grid one near-tie);
- `with_tiny_zoe` puts a config on the zoe branch with the JAX tests'
  tiny ZoeDepth-NK tower;
- `learn_merges` writes a BPE merges file in the format of CLIP's
  bpe_simple_vocab_16e6.txt.gz, learned from the vocabulary prompts;
- `write_weights_dir` writes a semantic dump (with the `ov_classifier` text
  tower) and a depth dump of the config's branch (DA-V2, or ZoeDepth-NK
  for a zoe config, with the config's LoRA adapters) as .pth files, and
  the merges, in the reference README's layout that `selftest
  --weights-dir` resolves.
"""

import collections
import dataclasses
import gzip
import os

import numpy as np
import torch

from ref_layout_mirror import make_dav2_sd, make_san_semantic_sd, make_zoedepth_sd

from veon_tpu_torch.nn import text as ptext


# JAX's tiny ZoeDepth-NK tower (`tests/test_zoedepth.py` `_tiny_zoe`)
TINY_ZOE = dict(width=32, depth=2, heads=2, patch_size=16, hooks=(0, 1, 1, 1),
                pyramid_channels=(8, 16, 16, 16), features=8, n_bins=6, bin_embedding_dim=8,
                n_attractors=(4, 2, 2, 1), lora_r=2)


def with_tiny_zoe(cfg):
    """`cfg` (a port or JAX config) on the zoe branch: the tiny tower,
    midas-normalized depth input at depth_input_size."""
    return dataclasses.replace(cfg, depth_mode="zoedepth", zoe=type(cfg.zoe)(**TINY_ZOE),
                               data=dataclasses.replace(cfg.data, depth_norm_method="midas"))


def spread(sd, seed=0):
    """A copy of a mirror state_dict (values N(0, 0.02)) at trained scales:
    matrices, conv kernels and LoRA factors N(0, 1/fan_in) (the projection
    matrices `proj` / `text_projection`, used as x @ P, by their first
    axis), LayerNorm / BatchNorm scales and LayerScales 1 + N(0, 0.1),
    other vectors N(0, 0.1) (BEiT's q and v biases among them), BEiT's
    relative-position tables N(0, 1), BatchNorm running means N(0, 0.1)
    and variances U(0.5, 1.5); position embeddings, tokens, logit_scale,
    buffers and counters as they are. The mirror values are rescaled, so
    the result follows the mirror's own seed; `seed` draws the running
    stats."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif leaf == "running_mean":
            v = 0.1 * rng.standard_normal(v.shape)
        elif not np.issubdtype(v.dtype, np.floating) or leaf == "attn_mask":
            pass
        elif v.ndim == 1:
            v = 1.0 + 5.0 * v if leaf in ("weight", "gamma", "gamma_1", "gamma_2") else 5.0 * v
        elif leaf == "relative_position_bias_table":
            v = v * (1.0 / 0.02)
        elif leaf in ("weight", "in_proj_weight", "lora_A", "lora_B"):
            v = v * (1.0 / (0.02 * np.sqrt(np.prod(v.shape[1:]))))
        elif leaf in ("proj", "text_projection"):
            v = v * (1.0 / (0.02 * np.sqrt(v.shape[0])))
        out[k] = np.asarray(v, sd[k].dtype)
    return out


def learn_merges(path, rounds=300):
    """A BPE merges file at `path` learned from the prompts of the
    nuscenes_brief vocabulary under the vild templates (most frequent pair
    first, ties by the pair's order): a header line, then one merge per
    line, gzipped."""
    tok = ptext.ClipTokenizer(None)
    prompts, _ = ptext.build_vocabulary("nuscenes_brief")
    words = collections.Counter()
    for text in [t.format(p) for t in ptext.get_templates("vild") for p in prompts]:
        text = ptext._whitespace_clean(ptext._basic_clean(text)).lower()
        for w in ptext.re.findall(tok.pat, text):
            w = "".join(tok.byte_encoder[b] for b in w.encode("utf-8"))
            words[tuple(w[:-1]) + (w[-1] + "</w>",)] += 1
    merges = []
    for _ in range(rounds):
        pairs = collections.Counter()
        for w, n in words.items():
            for pair in zip(w[:-1], w[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        merges.append(best)
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: test\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    return path


def _save(sd, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)


def write_weights_dir(cfg, root):
    """The reference README's checkpoint layout under `root` for `cfg` (a
    port or JAX config): clipsan/SAN_ViT-B.pth (SAN_ViT-L.pth for a ViT-L
    CLIP), a semantic dump with cfg.num_temporal frames, the text tower,
    bg_embed and logit_scale; depth_pretrain/depthanythingv2_pretrain_large.pth,
    a DA-V2 dump with LoRA adapters of rank cfg.depth.lora_r, or for a zoe
    config (depth_mode "zoedepth") depth_pretrain/zoedepth_pretrain.pth, a
    ZoeDepth-NK dump with adapters of rank cfg.zoe.lora_r;
    bpe_simple_vocab_16e6.txt.gz. Returns {"san", "depth", "bpe": path}."""
    vit = "L" if cfg.san.clip_width > 768 else "B"
    zoe = cfg.depth_mode == "zoedepth"
    paths = {"san": os.path.join(root, "clipsan", f"SAN_ViT-{vit}.pth"),
             "depth": os.path.join(root, "depth_pretrain", "zoedepth_pretrain.pth" if zoe
                                   else "depthanythingv2_pretrain_large.pth"),
             "bpe": os.path.join(root, "bpe_simple_vocab_16e6.txt.gz")}
    sd = spread(make_san_semantic_sd(cfg, num_temporal=cfg.num_temporal), 0)
    sd["ov_classifier.logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    _save(sd, paths["san"])
    del sd
    depth = make_zoedepth_sd(cfg.zoe, lora_r=cfg.zoe.lora_r) if zoe else \
        make_dav2_sd(cfg.depth, lora_r=cfg.depth.lora_r)
    _save(spread(depth, 1), paths["depth"])
    del depth
    learn_merges(paths["bpe"])
    return paths


def test_spread_keeps_the_layout_and_sets_trained_scales():
    from veon_tpu_torch.configs import presets

    cfg = presets.veon_tiny_test()
    sd = make_dav2_sd(cfg.depth, lora_r=4)
    out = spread(sd)
    assert out.keys() == sd.keys()
    assert all(out[k].shape == sd[k].shape and out[k].dtype == sd[k].dtype for k in sd)
    qkv = out["pretrained.blocks.0.attn.qkv.weight"]  # (3d, d): N(0, 1/d)
    assert abs(qkv.std() * np.sqrt(qkv.shape[1]) - 1.0) < 0.05
    norm = out["pretrained.blocks.0.norm1.weight"]
    assert abs(norm.mean() - 1.0) < 0.05 and 0.05 < norm.std() < 0.15
    np.testing.assert_array_equal(out["pretrained.pos_embed"], sd["pretrained.pos_embed"])


def test_learned_merges_shorten_the_prompts(tmp_path):
    path = learn_merges(str(tmp_path / "merges.txt.gz"))
    tok = ptext.ClipTokenizer(path)
    assert not tok.fallback
    assert len(tok.encode("a photo of a construction vehicle.")) < 12


def test_spread_sets_trained_scales_on_the_zoe_dump():
    """The BEiT leaves a zero table, zero q/v biases or unit LayerScales
    would leave idle: tables N(0, 1), biases N(0, 0.1), LayerScales
    1 + N(0, 0.1); the index buffer as it is."""
    from veon_tpu_torch.configs.base import ZoeConfig

    sd = make_zoedepth_sd(ZoeConfig(**TINY_ZOE), lora_r=2)
    out = spread(sd)
    assert out.keys() == sd.keys()
    b = "core.core.pretrained.model.blocks.1."
    table = out[b + "attn.relative_position_bias_table"]
    assert abs(table.std() - 1.0) < 0.05
    for k in ("attn.q_bias", "attn.v_bias"):
        assert 0.05 < out[b + k].std() < 0.15, k
    for k in ("gamma_1", "gamma_2"):
        assert abs(out[b + k].mean() - 1.0) < 0.1 and 0.03 < out[b + k].std() < 0.2, k
    lora_b = out[b + "attn.qkv.lora_B"]  # (3d, r): N(0, 1/r)
    assert abs(lora_b.std() * np.sqrt(lora_b.shape[1]) - 1.0) < 0.1
    np.testing.assert_array_equal(out[b + "attn.relative_position_index"],
                                  sd[b + "attn.relative_position_index"])
