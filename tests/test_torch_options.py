"""The model options no preset uses, against the JAX reference on the CPU,
fp32: the rec head's REC_CROSS_ATTN=False mode (the joint [sos, cls,
pixels] sequence under `rec_self_attn_mask`), the bilinear rec-bias
downsample, both through the whole F=1 forward too, and the SID frustum
with `absolute_depth_from_bins`. Weights are the perturbed tiny
reference's, carried by `from_jax`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import port_tiny_cfg, tiny_reference, to_np, to_torch

from veon_tpu.geometry.frustum import create_frustum as j_create_frustum
from veon_tpu.lift.lss import absolute_depth_from_bins as j_absolute_depth
from veon_tpu.lift.lss import sid_depth_values as j_sid
from veon_tpu.nn import vit as j_vit

from veon_tpu_torch import entry as entry_mod
from veon_tpu_torch.ckpt.from_jax import load_from_jax
from veon_tpu_torch.configs.base import GridConfig
from veon_tpu_torch.geometry.frustum import create_frustum
from veon_tpu_torch.lift.lss import absolute_depth_from_bins, sid_depth_values
from veon_tpu_torch.nn import vit as t_vit

TOL = dict(rtol=1e-4, atol=1e-4)  # the module tests' (`test_torch_modules.py`)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    return tiny_reference()


@pytest.fixture(scope="module")
def feats(ref):
    """The tiny reference's CLIP trunk features of its batch."""
    from veon_tpu.ops.resize import resize_bilinear

    c = ref["cfg"]
    flat = ref["imgs"].reshape((-1,) + ref["imgs"].shape[3:])
    clip_in = resize_bilinear(flat, (flat.shape[1] // 2, flat.shape[2] // 2))
    save = tuple(sorted({cl for _, cl in c.san.fusion_map}
                        | {ca for _, ca, _ in c.hsa.fusion_map}
                        | {ad for _, _, ad in c.hsa.fusion_map}
                        | {c.san.feature_last_layer_idx}))
    jm = j_vit.CLIPVisualExtractor(
        width=c.san.clip_width, heads=c.san.clip_heads, num_layers=c.san.feature_last_layer_idx,
        patch_size=c.san.clip_patch_size, pretrain_grid=c.san.clip_pretrain_grid,
        save_layers=save)
    out = jm.apply({"params": ref["variables"]["params"]["clip_visual"]}, clip_in)
    return {k: np.asarray(v) for k, v in out.items()}


def _heads(ref, cross_attn, method):
    c, t = ref["cfg"].san, port_tiny_cfg().san
    jm = j_vit.CLIPRecHead(width=c.clip_width, heads=c.clip_heads,
                           first_layer_idx=c.feature_last_layer_idx, total_layers=c.clip_layers,
                           out_dim=c.clip_embed_dim, sos_token_num=c.num_queries,
                           downsample_method=method, cross_attn=cross_attn)
    tm = t_vit.CLIPRecHead(t.clip_width, t.clip_heads, t.feature_last_layer_idx, t.clip_layers,
                           t.clip_embed_dim, t.num_queries, method, cross_attn)
    # the cross mode's weights: one parameter tree serves both modes
    variables = {"params": ref["variables"]["params"]["rec_head"]}
    return jm, load_from_jax(tm, variables), variables


@pytest.mark.parametrize("method", ["max", "bilinear"])
@pytest.mark.parametrize("cross_attn", [False, True], ids=["self_attn", "cross_attn"])
def test_rec_head_modes_match_reference(ref, feats, cross_attn, method):
    """Mask embeddings of both modes and both downsample methods at 1e-4,
    with unit norm; the SAN bias at its own side grid (not the CLIP one)."""
    c = ref["cfg"].san
    jm, tm, variables = _heads(ref, cross_attn, method)
    B, h, w, _ = feats["0"].shape
    bias = _rand(6, B, 1, c.num_queries, h + 1, w + 2)
    want = np.asarray(jm.apply(variables, {k: jnp.asarray(v) for k, v in feats.items()},
                               jnp.asarray(bias)))
    with torch.no_grad():
        got = to_np(tm({k: to_torch(v) for k, v in feats.items()}, to_torch(bias)))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)


def test_rec_head_self_attn_update_remaining_is_mode_independent(ref, feats):
    """update_remaining of the self-attention head equals JAX's and the
    cross-attention head's (the mode only changes the rec path)."""
    c = ref["cfg"]
    jm, tm, variables = _heads(ref, False, "max")
    _, tx, _ = _heads(ref, True, "max")
    B, h, w, _ = feats["0"].shape
    factors = 0.3 * _rand(7, c.hsa.manip_attn_layers, B, h * w, c.san.clip_heads, 4)
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in feats.items()},
                    jnp.asarray(factors), method=j_vit.CLIPRecHead.update_remaining)
    with torch.no_grad():
        got = tm.update_remaining({k: to_torch(v) for k, v in feats.items()}, to_torch(factors))
        cross = tx.update_remaining({k: to_torch(v) for k, v in feats.items()},
                                    to_torch(factors))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), err_msg=k, **TOL)
        assert torch.equal(got[k], cross[k]), k


def test_rec_self_attn_mask_matches_reference():
    """The dense mask equals JAX's bit for bit: -100 on the sos columns
    but each sos's own, -100 from sos to cls, the bias on sos -> pixels."""
    b = _rand(3, 2, 2, 3, 4)
    got = to_np(t_vit.rec_self_attn_mask(to_torch(b)))
    np.testing.assert_array_equal(got, np.asarray(j_vit.rec_self_attn_mask(jnp.asarray(b))))
    Q, L = 3, 4
    assert got[0, 0, 1, 1] == 0.0 and got[0, 0, 1, 0] == -100.0 and got[0, 0, 1, Q] == -100.0
    np.testing.assert_array_equal(got[..., :Q, -L:], b)


def test_rec_head_self_attn_mode_against_the_published_formulation():
    """The case of `tests/test_ckpt_convert.py::test_rec_head_self_attn_mode
    _parity`: torch `nn.MultiheadAttention` blocks under the reference's
    mask construction, the port's head loaded with the same weights through
    the JAX converter, at that test's 3e-4 / 3e-5."""
    import torch.nn.functional as tF
    from torch import nn as tnn

    from test_ckpt_convert import C, TorchCLIPBlock, _sd

    d, heads, Q, B, h, w, n = 16, 4, 3, 2, 2, 3, 2
    L, S = h * w, Q + 1 + h * w
    torch.manual_seed(0)

    class TorchMaskBlock(TorchCLIPBlock):
        def forward(self, x, attn_mask):  # x: (S, N, D)
            y = self.ln_1(x)
            x = x + self.attn(y, y, y, need_weights=False, attn_mask=attn_mask)[0]
            return x + self.mlp(self.ln_2(x))

    blocks = [TorchMaskBlock(d, heads).eval() for _ in range(n)]
    ln_post = tnn.LayerNorm(d).eval()
    proj = torch.from_numpy(_rand(10, d, 8))
    pix, cls, bias = _rand(11, B, h, w, d), _rand(12, B, 1, d), _rand(13, B, heads, Q, L)
    base = np.zeros((S, S), np.float32)
    base[:, :Q] = -100.0
    base[np.arange(Q), np.arange(Q)] = 0.0
    base[:Q, Q] = -100.0
    mask = np.broadcast_to(base, (B, heads, S, S)).copy()
    mask[..., :Q, -L:] = bias
    with torch.no_grad():
        sos = torch.from_numpy(cls).permute(1, 0, 2).repeat(Q, 1, 1)
        x = torch.cat([sos, torch.from_numpy(cls).permute(1, 0, 2),
                       torch.from_numpy(pix.reshape(B, L, d)).permute(1, 0, 2)], 0)
        for blk in blocks:
            x = blk(x, torch.from_numpy(mask.reshape(B * heads, S, S)))
        want = tF.normalize(ln_post(x[:Q].permute(1, 0, 2)) @ proj, dim=-1).numpy()
    params = {"resblocks": {"block": C._stack([C._clip_block(_sd(b), "") for b in blocks])},
              "ln_post": C._ln(_sd(ln_post), ""), "proj_kernel": proj.numpy()}
    tm = load_from_jax(t_vit.CLIPRecHead(d, heads, 2, 4, 8, Q, cross_attn=False),
                       {"params": params})
    with torch.no_grad():
        got = tm({"2": to_torch(pix), "2_cls": to_torch(cls)},
                 to_torch(bias.reshape(B, heads, Q, h, w)))
    np.testing.assert_allclose(to_np(got), want, rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("method", ["max", "bilinear"])
def test_format_attn_biases_matches_reference(method):
    """(B, Hb, Q, h, w) -> (B, heads, Q, Ht*Wt) at 1e-6, Hb = 1 broadcast
    over the heads and Hb = heads kept; an unknown method raises
    ValueError, as in JAX."""
    for hb in (1, 3):
        b = _rand(4, 2, hb, 5, 9, 13)
        want = np.asarray(j_vit.format_attn_biases(jnp.asarray(b), (4, 6), 3, method))
        got = to_np(t_vit.format_attn_biases(to_torch(b), (4, 6), 3, method))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        t_vit.format_attn_biases(to_torch(b), (4, 6), 3, "nearest")


def test_full_forward_with_self_attn_rec_head_and_bilinear_downsample(ref):
    """The F=1 serving slice with REC_CROSS_ATTN=False and the bilinear rec
    downsample, port (`entry`, presorted lift) against JAX's full_forward
    on the same weights and batch, at the slice's 2e-4
    (`test_torch_slice.py`)."""
    from veon_tpu.model.veon import VeonModel

    def opts(cfg):
        return dataclasses.replace(cfg, san=dataclasses.replace(
            cfg.san, rec_cross_attn=False, rec_downsample_method="bilinear"))

    jcfg = opts(ref["cfg"])
    want = jax.jit(VeonModel(cfg=jcfg).apply, static_argnames=("train", "method"))(
        ref["variables"], ref["imgs"], ref["depth_imgs"], ref["metas"], ref["ovw"],
        train=False, method=VeonModel.full_forward)
    server, (imgs, depth_imgs) = entry_mod.entry(opts(port_tiny_cfg()), device="cpu",
                                                 variables=ref["variables"])
    got = server.outputs(imgs, depth_imgs)
    for k in ("sem_seg_ds", "sem_embed_ds", "bin_occ", "feat_occ", "clip_feat"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
    # the options change the rec path: the cross-attention default differs
    assert not np.allclose(np.asarray(want["sem_seg_ds"]), ref["out"]["sem_seg_ds"], atol=1e-3)


def test_absolute_depth_and_sid():
    """The cases of `tests/test_geometry_lift.py::test_absolute_depth_and_sid`
    on both sides: the expected and hard depth of a two-bin distribution,
    the SID planes (float64, then float32: bit-equal to JAX's), their ends
    and growing spacing, and the SID frustum's depth axis."""
    grid = GridConfig(x=(-10.0, 10.0, 1.0), y=(-10.0, 10.0, 1.0), z=(-2.0, 2.0, 1.0),
                      depth=(1.0, 9.0, 1.0))
    from veon_tpu.configs.base import GridConfig as JGrid

    jgrid = JGrid(**{f.name: getattr(grid, f.name) for f in dataclasses.fields(JGrid)})
    bins = np.zeros((2, 10), np.float32)
    bins[:, 3], bins[:, 4] = 0.6, 0.4
    avg, hard = absolute_depth_from_bins(to_torch(bins), grid)
    javg, jhard = j_absolute_depth(jnp.asarray(bins), jgrid)
    np.testing.assert_allclose(to_np(avg), 0.6 * 3.5 + 0.4 * 4.5, rtol=1e-6)
    np.testing.assert_allclose(to_np(hard), 3.5, rtol=1e-6)
    np.testing.assert_allclose(to_np(avg), np.asarray(javg), rtol=1e-6)
    np.testing.assert_array_equal(to_np(hard), np.asarray(jhard))

    sid = sid_depth_values(grid)
    np.testing.assert_array_equal(sid, j_sid(jgrid))
    assert sid.shape == (8,) and sid.dtype == np.float32
    np.testing.assert_allclose(sid[0], grid.depth[0], rtol=1e-5)
    np.testing.assert_allclose(sid[-1], grid.depth[1] - 1.0, rtol=1e-5)
    assert np.all(np.diff(sid) > 0) and np.diff(sid)[-1] > np.diff(sid)[0]
    fr = create_frustum(grid, (16, 16), 4, sid=True)
    np.testing.assert_array_equal(fr, j_create_frustum(jgrid, (16, 16), 4, sid=True))
    np.testing.assert_allclose(fr[:, 0, 0, 2], sid, rtol=1e-6)
    np.testing.assert_array_equal(create_frustum(grid, (16, 16), 4),
                                  j_create_frustum(jgrid, (16, 16), 4))
