"""Each module of the port's serving slice against its flax counterpart on
the CPU, fp32, the same (perturbed, `from_jax`-carried) weights and the same
numpy inputs, at rtol/atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import perturbed, port_tiny_cfg, tiny_reference, to_np, to_torch

from veon_tpu.nn import alignnet as j_align
from veon_tpu.nn import attention as j_attn
from veon_tpu.nn import dpt as j_dpt
from veon_tpu.nn import hsa as j_hsa
from veon_tpu.nn import layers as j_layers
from veon_tpu.nn import san as j_san
from veon_tpu.nn import vit as j_vit

from veon_tpu_torch.ckpt.from_jax import load_from_jax
from veon_tpu_torch.nn import alignnet as t_align
from veon_tpu_torch.nn import attention as t_attn
from veon_tpu_torch.nn import dpt as t_dpt
from veon_tpu_torch.nn import hsa as t_hsa
from veon_tpu_torch.nn import layers as t_layers
from veon_tpu_torch.nn import san as t_san
from veon_tpu_torch.nn import vit as t_vit

TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), err_msg=k, **TOL)
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def _tt(x):
    """numpy / jax pytree -> torch tensors."""
    if isinstance(x, dict):
        return {k: _tt(v) for k, v in x.items()}
    return to_torch(np.asarray(x))


def _standalone(jmod, tmod, *inputs, seed=0, **kw):
    """Init `jmod` with flax, perturb, carry into `tmod`, compare one call."""
    variables = perturbed(jmod.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs), **kw), seed)
    want = jmod.apply(variables, *map(jnp.asarray, inputs), **kw)
    load_from_jax(tmod, variables)
    with torch.no_grad():
        got = tmod(*map(to_torch, inputs), **kw)
    _close(got, want)


def test_layernorm_and_mlp():
    x = _rand(0, 2, 5, 12)
    _standalone(j_layers.LayerNorm(), t_layers.LayerNorm(12), x)
    _standalone(j_layers.MLP(hidden_dim=20, output_dim=7, num_layers=3),
                t_layers.MLP(12, 20, 7, 3), x)


@pytest.mark.parametrize("mode", ["self", "self_bias", "factorized_bias", "cross"])
def test_fused_qkv_attention(mode):
    B, L, E, H, K = 2, 9, 16, 2, 5
    x, jm, tm = _rand(1, B, L, E), j_attn.FusedQKVAttention(num_heads=H), \
        t_attn.FusedQKVAttention(E, H)
    variables = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    load_from_jax(tm, variables)
    if mode == "cross":
        args = (_rand(2, B, K, E),)
        kw = dict(bias=_rand(3, B, H, K, L), mode="cross", mem=x)
    else:
        args = (x,)
        kw = {"self": {}, "self_bias": dict(bias=_rand(3, B, H, L, L)),
              "factorized_bias": dict(extra_qk=_rand(4, B, L, H, 3))}[mode]
    want = jm.apply(variables, *map(jnp.asarray, args),
                    **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    with torch.no_grad():
        got = tm(*map(to_torch, args),
                 **{k: to_torch(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    _close(got, want)


def test_simple_attention():
    _standalone(j_attn.SimpleAttention(num_heads=2), t_attn.SimpleAttention(16, 2),
                _rand(5, 2, 7, 16))


@pytest.fixture(scope="module")
def ref():
    return tiny_reference()


@pytest.fixture(scope="module")
def clip_feats(ref):
    """The CLIP trunk's features of the reference batch (the towers' input)."""
    from veon_tpu.ops.resize import resize_bilinear

    cfg = ref["cfg"]
    flat = ref["imgs"].reshape((-1,) + ref["imgs"].shape[3:])
    clip_in = resize_bilinear(flat, (flat.shape[1] // 2, flat.shape[2] // 2))
    jm = _jax_clip(cfg)
    feats = jm.apply({"params": ref["variables"]["params"]["clip_visual"]}, clip_in)
    return np.asarray(flat), np.asarray(clip_in), {k: np.asarray(v) for k, v in feats.items()}


def _save_layers(c):
    return tuple(sorted({cl for _, cl in c.san.fusion_map}
                        | {ca for _, ca, _ in c.hsa.fusion_map}
                        | {ad for _, _, ad in c.hsa.fusion_map}
                        | {c.san.feature_last_layer_idx}))


def _jax_clip(c):
    return j_vit.CLIPVisualExtractor(
        width=c.san.clip_width, heads=c.san.clip_heads, num_layers=c.san.feature_last_layer_idx,
        patch_size=c.san.clip_patch_size, pretrain_grid=c.san.clip_pretrain_grid,
        save_layers=_save_layers(c))


def _sub(ref, name):
    v = {"params": ref["variables"]["params"][name]}
    if name in ref["variables"].get("batch_stats", {}):
        v["batch_stats"] = ref["variables"]["batch_stats"][name]
    return v


def _port_rec_head(t):
    return t_vit.CLIPRecHead(t.san.clip_width, t.san.clip_heads, t.san.feature_last_layer_idx,
                             t.san.clip_layers, t.san.clip_embed_dim, t.san.num_queries)


def _jax_rec_head(c):
    return j_vit.CLIPRecHead(
        width=c.san.clip_width, heads=c.san.clip_heads, first_layer_idx=c.san.feature_last_layer_idx,
        total_layers=c.san.clip_layers, out_dim=c.san.clip_embed_dim,
        sos_token_num=c.san.num_queries)


@pytest.mark.parametrize("part", ["dinov2_trunk", "dpt_head"])
def test_depth_tower(ref, part):
    """DINOv2 trunk tokens, then the DPT head's sigmoid depth on the same
    tokens (before the x max_depth scale, which would scale the tolerance)."""
    c, t = ref["cfg"], port_tiny_cfg()
    x = np.asarray(ref["depth_imgs"]).reshape((-1,) + ref["depth_imgs"].shape[3:])
    p = _sub(ref, "depth")["params"]
    vit, ph, pw = c.depth.vit, x.shape[1] // 14, x.shape[2] // 14
    jt = j_vit.DinoV2Trunk(width=vit.width, depth=vit.depth, heads=vit.heads,
                           take_layers=c.depth.intermediate_layer_idx)
    tokens = jt.apply({"params": p["pretrained"]}, jnp.asarray(x))
    if part == "dinov2_trunk":
        tm = t_vit.DinoV2Trunk(vit.width, vit.depth, vit.heads,
                               take_layers=t.depth.intermediate_layer_idx)
        load_from_jax(tm, {"params": p["pretrained"]})
        with torch.no_grad():
            _close(tm(to_torch(x)), tokens)
        return
    toks = [np.asarray(tk) for tk, _cls in tokens]
    want = j_dpt.DPTHead(features=c.depth.features, out_channels=c.depth.out_channels).apply(
        {"params": p["depth_head"]}, [jnp.asarray(tk) for tk in toks], (ph, pw))
    tm = t_dpt.DPTHead(vit.width, t.depth.features, t.depth.out_channels)
    load_from_jax(tm, {"params": p["depth_head"]})
    with torch.no_grad():
        _close(tm([to_torch(tk) for tk in toks], (ph, pw)), want)


def test_clip_visual_extractor(ref, clip_feats):
    t = port_tiny_cfg()
    _, clip_in, want = clip_feats
    tm = t_vit.CLIPVisualExtractor(t.san.clip_width, t.san.clip_heads, t.san.feature_last_layer_idx,
                                   t.san.clip_patch_size, t.san.clip_pretrain_grid,
                                   _save_layers(t))
    load_from_jax(tm, _sub(ref, "clip_visual"))
    with torch.no_grad():
        _close(tm(to_torch(clip_in)), want)


def test_side_adapter_network(ref, clip_feats):
    flat, _, feats = clip_feats
    want = j_san.SideAdapterNetwork(cfg=ref["cfg"].san).apply(
        _sub(ref, "side_adapter"), jnp.asarray(flat), feats)
    tm = load_from_jax(t_san.SideAdapterNetwork(port_tiny_cfg().san), _sub(ref, "side_adapter"))
    with torch.no_grad():
        _close(tm(to_torch(flat), _tt(feats)), want)


@pytest.mark.parametrize("entry", ["rec", "update_remaining"])
def test_clip_rec_head(ref, clip_feats, entry):
    c, t = ref["cfg"], port_tiny_cfg()
    _, _, feats = clip_feats
    jm, tm = _jax_rec_head(c), load_from_jax(_port_rec_head(t), _sub(ref, "rec_head"))
    B, h, w, _ = feats["0"].shape
    if entry == "rec":
        bias = _rand(6, B, 1, c.san.num_queries, h + 1, w + 2)  # SAN bias at the side grid
        want = jm.apply(_sub(ref, "rec_head"), feats, jnp.asarray(bias))
        with torch.no_grad():
            got = tm(_tt(feats), to_torch(bias))
    else:
        factors = 0.3 * _rand(7, c.hsa.manip_attn_layers, B, h * w, c.san.clip_heads, 4)
        want = jm.apply(_sub(ref, "rec_head"), feats, jnp.asarray(factors),
                        method=j_vit.CLIPRecHead.update_remaining)
        with torch.no_grad():
            got = tm.update_remaining(_tt(feats), to_torch(factors))
    _close(got, want)


def test_highres_side_adaptor(ref, clip_feats):
    flat, _, feats = clip_feats
    want = j_hsa.HighresSideAdaptor(cfg=ref["cfg"].hsa).apply(_sub(ref, "hsa"), jnp.asarray(flat),
                                                              feats)
    tm = load_from_jax(t_hsa.HighresSideAdaptor(port_tiny_cfg().hsa), _sub(ref, "hsa"))
    with torch.no_grad():
        _close(tm(to_torch(flat), _tt(feats)), want)


def test_lift_fusion_and_alignnet3d(ref):
    c, t = ref["cfg"], port_tiny_cfg()
    BN, (h, w) = 6, c.feat_hw
    supp = _rand(8, BN, 8, 22, c.hsa.manip_supp_dim)
    clip = _rand(9, BN, 2, 5, c.san.clip_width)
    want = j_align.LiftFusion(cfg=c.propagation).apply(_sub(ref, "lift_fusion"), jnp.asarray(supp),
                                                       jnp.asarray(clip), (h, w))
    tf = load_from_jax(t_align.LiftFusion(t.propagation, t.hsa.manip_supp_dim, t.san.clip_width),
                       _sub(ref, "lift_fusion"))
    with torch.no_grad():
        _close(tf(to_torch(supp), to_torch(clip), (h, w)), want)
    nx, ny, nz = c.grid.size
    vox = _rand(10, 1, nz // 2, ny // 2, nx // 2, c.propagation.dim)
    jm = j_align.AlignNet3D(cfg=c.propagation, clip_outdim=c.propagation.clip_proj_dim)
    want = jm.apply(_sub(ref, "alignnet"), jnp.asarray(vox))
    ta = load_from_jax(t_align.AlignNet3D(t.propagation, t.propagation.clip_proj_dim),
                       _sub(ref, "alignnet"))
    with torch.no_grad():
        _close(ta(to_torch(vox)), want)
