"""The port's checkpoint conversion (`veon_tpu_torch/ckpt/convert.py`)
against the JAX converter on the CPU, on the reference-layout mirror dumps
of `tests/ref_layout_mirror.py`: `convert_san_semantic` at T=1 and T=2
and `convert_dav2` with and without LoRA equal to JAX's leaf for leaf
(`np.array_equal`, same tree), every mirror key read, the result loaded
strictly by the port and of the JAX model's structure; `merge_lora`,
`fuse_conv_bn`, `merge_params`, `revise_keys` and `load_torch_state_dict`
equal to JAX's; a forward with conv-BN folded equal to the unfolded one
within 1e-5. `convert_zoedepth` with and without LoRA bit-equal to JAX's,
every key read but the index buffers, folded and loaded strictly into the
port's zoe tower with JAX's depth; `load_checkpoints` routing a zoe
preset's depth dump to it and `resolve_weights_dir` picking the zoe file.
Then the presets field by field (the zoe presets included), and a
patch-14 config whose HSA blocks take the CLIP grid of one layer and add
another's, loaded from mirror dumps on both sides, against JAX's forward
within 2e-4."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_ckpt_full_convert import (IGNORED_KEYS, IGNORED_PREFIXES, IGNORED_SUFFIXES,
                                    ZOE_IGNORED_SUFFIXES, TrackingSD)
from test_torch_common import np_tree, to_np
from test_torch_mirror import spread, with_tiny_zoe, write_weights_dir
from test_torch_zoedepth import tiny_zoe
from ref_layout_mirror import make_dav2_sd, make_san_semantic_sd, make_zoedepth_sd

from veon_tpu.ckpt import convert as J
from veon_tpu.configs import presets as jpresets
from veon_tpu_torch.ckpt import convert as P
from veon_tpu_torch.ckpt.from_jax import load_families, load_from_jax
from veon_tpu_torch.configs import presets
from veon_tpu_torch.model.veon import VOXEL_OUTPUTS, VeonModel


def _unread(sd):
    return sorted(k for k in sd if k not in sd.read and not k.endswith(IGNORED_SUFFIXES)
                  and not k.startswith(IGNORED_PREFIXES) and k not in IGNORED_KEYS)


def assert_tree_equal(got, want, path=""):
    """Same keys at every level and every leaf bit-equal, dtype and shape."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, sorted(got), sorted(want))
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert np.array_equal(got, want), path


@pytest.fixture(scope="module")
def san_dumps():
    """{T: mirror semantic dump} at the tiny preset, T = 1 and 2."""
    return {T: make_san_semantic_sd(jpresets.veon_tiny_test(num_temporal=T), num_temporal=T)
            for T in (1, 2)}


@pytest.fixture(scope="module")
def dav2_dumps():
    cfg = jpresets.veon_tiny_test()
    return {r: make_dav2_sd(cfg.depth, lora_r=r) for r in (0, cfg.depth.lora_r)}


@pytest.mark.parametrize("T", [1, 2])
def test_san_semantic_equals_reference_and_loads_strictly(san_dumps, T):
    jcfg, pcfg = jpresets.veon_tiny_test(num_temporal=T), presets.veon_tiny_test(num_temporal=T)
    sd = TrackingSD(san_dumps[T])
    params, stats, extras = P.convert_san_semantic(sd, pcfg)
    assert _unread(sd) == []
    want = J.convert_san_semantic(dict(san_dumps[T]), jcfg)
    for got, ref in zip((params, stats, extras), want):
        assert_tree_equal(got, ref)
    assert ("temporal_fusion" in params["alignnet"]) == (T > 1)
    assert set(extras) == {"text_tower", "bg_embed", "logit_scale"}
    # the port: every converted family fills its module, strict both ways
    model = VeonModel(pcfg, device="cpu")
    load_families(model, {"params": params, "batch_stats": stats})
    # the reference: of the JAX model's structure, family by family
    from test_ckpt_full_convert import assert_same_structure

    from veon_tpu.cli.shapes import example_batch_full
    from veon_tpu.model.veon import VeonModel as JaxModel

    imgs, depth_imgs, metas = example_batch_full(jcfg, B=1)
    init = jax.eval_shape(lambda: JaxModel(cfg=jcfg).init(
        jax.random.PRNGKey(0), imgs, depth_imgs, metas, np.zeros((3, 16), np.float32),
        train=False, method=JaxModel.full_forward))
    for fam in params:
        assert_same_structure(params[fam], init["params"][fam], fam)
    for fam in stats:
        assert_same_structure(stats[fam], init["batch_stats"][fam], f"stats.{fam}")


@pytest.mark.parametrize("lora", ["none", "r16"])
def test_dav2_equals_reference_and_loads_strictly(dav2_dumps, lora):
    jcfg, pcfg = jpresets.veon_tiny_test(), presets.veon_tiny_test()
    r = 0 if lora == "none" else pcfg.depth.lora_r
    sd = TrackingSD(dav2_dumps[r])
    got = P.convert_dav2(sd, pcfg.depth)
    assert _unread(sd) == []
    want = J.convert_dav2(dict(dav2_dumps[r]), jcfg.depth)
    assert_tree_equal(got, want)
    merged = P.merge_lora(got, pcfg.depth.lora_alpha)
    assert_tree_equal(merged, J.merge_lora(want, jcfg.depth.lora_alpha))
    if r:  # the adapters really were folded: W + (alpha / r) A @ B
        q = "pretrained/segment_0_3/blocks/block/attn/qkv".split("/")
        node, base = got, merged
        for k in q:
            node, base = node[k], base[k]
        assert set(base) == {"base"}
        np.testing.assert_allclose(base["base"]["kernel"], node["base"]["kernel"]
                                   + node["lora_A"] @ node["lora_B"] / r, rtol=1e-6, atol=1e-7)
    model = VeonModel(pcfg, device="cpu")
    load_from_jax(model.depth, {"params": merged})


@pytest.mark.parametrize("r", [0, 2])
def test_zoedepth_equals_reference_and_gives_its_depth(r):
    """The converted ZoeDepth-NK dump equals JAX's tree leaf for leaf, every
    key read but the index buffers and counters; folded (scale 1 / r), it
    loads strictly into the port's tower, whose depth equals JAX's tower
    applying the adapters unfolded, at trained scales (`spread`)."""
    from veon_tpu.configs.base import ZoeConfig as JZoeConfig
    from veon_tpu.nn.zoedepth import ZoeDepthNK as JaxZoe
    from veon_tpu_torch.nn.zoedepth import ZoeDepthNK

    jzc = dataclasses.replace(tiny_zoe(JZoeConfig), use_lora=r > 0, lora_r=r or 2)
    pzc = dataclasses.replace(tiny_zoe(), use_lora=r > 0, lora_r=r or 2)
    raw = spread(make_zoedepth_sd(pzc, lora_r=r))
    sd = TrackingSD(raw)
    got = P.convert_zoedepth(sd, pzc)
    unread = sorted(k for k in sd if k not in sd.read and not k.endswith(ZOE_IGNORED_SUFFIXES)
                    and not k.startswith(IGNORED_PREFIXES))
    assert unread == []
    want = J.convert_zoedepth(dict(raw), jzc)
    assert_tree_equal(got, want)
    merged = P.merge_lora(got, 1.0)
    assert_tree_equal(merged, J.merge_lora(want, 1.0))
    assert ("lora_A" in got["core"]["readout_0"]["project"]) == (r > 0)
    tower = ZoeDepthNK(pzc)
    load_from_jax(tower, {"params": merged})
    img = np.random.default_rng(0).standard_normal((1, 32, 88, 3)).astype(np.float32)
    ref = jax.jit(JaxZoe(cfg=jzc).apply)({"params": want}, img)
    with torch.no_grad():
        depth = to_np(tower(torch.from_numpy(img)))
    assert np.isfinite(depth).all() and depth.std() > 0
    np.testing.assert_allclose(depth, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_load_checkpoints_routes_a_zoe_preset_to_convert_zoedepth(tmp_path):
    """--depth-load-from on a zoe preset converts through convert_zoedepth
    and folds its adapters (the counterpart of
    `test_build_model_and_params_routes_zoe_depth_ckpt`); DA-V2 presets keep
    convert_dav2."""
    from veon_tpu_torch.cli.main import build_model_and_params, load_checkpoints
    from veon_tpu_torch.nn.zoedepth import ZoeDepthNK

    cfg = with_tiny_zoe(presets.veon_tiny_test())
    sd = make_zoedepth_sd(cfg.zoe, lora_r=cfg.zoe.lora_r)
    path = str(tmp_path / "zoe.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    variables, extras = load_checkpoints(cfg, depth_ckpt=path)
    assert list(variables["params"]) == ["depth"] and extras == {}
    assert_tree_equal(variables["params"]["depth"],
                      P.merge_lora(P.convert_zoedepth(sd, cfg.zoe), 1.0))
    model, _tower, ovw, _m, _e = build_model_and_params(cfg, depth_ckpt=path, device="cpu")
    assert isinstance(model.depth, ZoeDepthNK)
    dimgs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 1, 2, 32, 88, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.isfinite(model.estimate_depth(dimgs)).all()
    with pytest.raises(KeyError):  # a DA-V2 preset reads it as a DA-V2 dump
        load_checkpoints(presets.veon_tiny_test(), depth_ckpt=path)


def test_resolve_weights_dir_picks_the_zoe_file(tmp_path):
    from veon_tpu_torch.cli.main import resolve_weights_dir

    for rel in ("clipsan/SAN_ViT-B.pth", "clipsan/SAN_ViT-L.pth",
                "depth_pretrain/depthanythingv2_pretrain_large.pth"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    root = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="zoedepth_pretrain.pth"):
        resolve_weights_dir(root, "veon_b_zoe")
    (tmp_path / "depth_pretrain" / "zoedepth_pretrain.pth").write_bytes(b"")
    for preset, vit in (("veon_b_zoe", "B"), ("veon_l_zoe", "L")):
        got = resolve_weights_dir(root, preset)
        assert got["depth"].endswith("depth_pretrain/zoedepth_pretrain.pth")
        assert got["san"].endswith(f"SAN_ViT-{vit}.pth")
    assert resolve_weights_dir(root, "veon_b")["depth"].endswith(
        "depthanythingv2_pretrain_large.pth")


def test_merge_params_and_revise_keys_equal_reference(san_dumps):
    sd = san_dumps[1]
    rules = [(r"^clip_", "semantic.clip_"), (r"\.ln_1\.", ".norm_a.")]
    got, want = P.revise_keys(sd, rules), J.revise_keys(sd, rules)
    assert list(got) == list(want) and any(k.startswith("semantic.clip_") for k in got)
    params, _, _ = P.convert_san_semantic(sd, presets.veon_tiny_test())
    jparams, _, _ = J.convert_san_semantic(sd, jpresets.veon_tiny_test())
    part = {"hsa": {"patch_embed": {"bias": np.ones(16, np.float32)}}}
    assert_tree_equal(P.merge_params(params, part), J.merge_params(jparams, part))
    for bad in ({"stray": np.zeros(2)}, {"hsa": {"patch_embed": np.zeros(2)}}):
        with pytest.raises(KeyError):
            J.merge_params(jparams, bad)
        with pytest.raises(KeyError):
            P.merge_params(params, bad)


def test_load_torch_state_dict_equals_reference(tmp_path, dav2_dumps):
    sd = {k: torch.from_numpy(v) for k, v in list(dav2_dumps[0].items())[:12]}
    for name, obj in (("plain", sd), ("wrapped", {"state_dict": sd, "meta": {"epoch": 3}}),
                      ("model", {"model": sd})):
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        got, want = P.load_torch_state_dict(path), J.load_torch_state_dict(path)
        assert list(got) == list(want) == list(sd)
        assert_tree_equal(got, want)


@pytest.fixture(scope="module")
def converted_tiny():
    """The tiny preset's converted variables from spread mirror dumps (the
    DA-V2 dump with LoRA), as numpy trees."""
    cfg = presets.veon_tiny_test()
    params, stats, _ = P.convert_san_semantic(spread(make_san_semantic_sd(cfg)), cfg)
    depth = P.convert_dav2(spread(make_dav2_sd(cfg.depth, lora_r=cfg.depth.lora_r), 1), cfg.depth)
    params["depth"] = P.merge_lora(depth, cfg.depth.lora_alpha)
    return cfg, {"params": params, "batch_stats": stats}


def test_fuse_conv_bn_equals_reference_and_keeps_the_forward(converted_tiny):
    from veon_tpu_torch.entry import entry

    cfg, variables = converted_tiny
    fp, fs = P.fuse_conv_bn(variables["params"], variables["batch_stats"])
    jp, js = J.fuse_conv_bn(variables["params"], variables["batch_stats"])
    assert_tree_equal(fp, np_tree(jp))
    assert_tree_equal(fs, np_tree(js))
    conv = fp["alignnet"]["res3d"]["block"]["conv1"]
    assert not np.array_equal(conv["conv"]["kernel"],
                              variables["params"]["alignnet"]["res3d"]["block"]["conv1"]["conv"]
                              ["kernel"])
    np.testing.assert_array_equal(conv["bn"]["scale"], 1.0)
    server, (imgs, depth_imgs) = entry(cfg, device="cpu", variables=variables)
    folded, _ = entry(cfg, device="cpu", variables={"params": fp, "batch_stats": fs})
    want, got = server.outputs(imgs, depth_imgs), folded.outputs(imgs, depth_imgs)
    for k in VOXEL_OUTPUTS:
        np.testing.assert_allclose(to_np(got[k]), to_np(want[k]), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("family", ["depth", "alignnet"])
def test_entry_refuses_a_partial_tree_and_only_the_cli_seeds_it(converted_tiny, family):
    """The entry points load a whole variables tree strictly: a tree
    without one family raises. Only the CLI's checkpoint route
    (`checkpoint_model`) seeds the families its files leave out, as the
    reference merges the converted families into its init tree."""
    from veon_tpu_torch.cli.main import checkpoint_model
    from veon_tpu_torch.entry import build_model, entry, serve_entry, train_entry

    cfg, variables = converted_tiny
    partial = {col: {f: t for f, t in tree.items() if f != family}
               for col, tree in variables.items()}
    for build in (entry, train_entry, serve_entry):
        with pytest.raises(ValueError, match="port entries with no JAX leaf"):
            build(cfg, device="cpu", variables=partial)
    cpu = torch.device("cpu")
    got = checkpoint_model(cfg, partial, device="cpu").state_dict()
    seeded = build_model(cfg, cpu, 0, None).state_dict()
    loaded = build_model(cfg, cpu, 0, variables).state_dict()
    assert got.keys() == seeded.keys() == loaded.keys()
    for name, t in got.items():
        want = seeded if name.startswith(family + ".") else loaded
        assert torch.equal(t, want[name]), name
    # the left-out family really took the seeded weights, not the converted ones
    assert any(not torch.equal(seeded[n], loaded[n]) for n in got if n.startswith(family + "."))


PRESETS = ["veon_b", "veon_b_fast", "veon_b_fast2", "veon_l", "veon_b_zoe", "veon_l_zoe",
           "veon_tiny_test"]


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_reference_field_by_field(name):
    for T in (1, 2):
        port, ref = getattr(presets, name)(num_temporal=T), getattr(jpresets, name)(num_temporal=T)
        for f in dataclasses.fields(port):
            p, r = getattr(port, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(p):
                for g in dataclasses.fields(p):
                    assert getattr(p, g.name) == getattr(r, g.name), (name, f.name, g.name)
            else:
                assert p == r, (name, f.name)
        for g in dataclasses.fields(port.depth.vit):
            assert getattr(port.depth.vit, g.name) == getattr(ref.depth.vit, g.name), g.name
        assert port.depth.intermediate_layer_idx == ref.depth.intermediate_layer_idx
        assert port.feat_hw == ref.feat_hw
        assert port.zoe == port.zoe.__class__(**dataclasses.asdict(ref.zoe))
        assert port.depth_mode == ref.depth_mode == ("zoedepth" if "zoe" in name
                                                     else "depthanythingv2")
    if name in ("veon_l", "veon_l_zoe"):  # fp32 only, as in JAX
        with pytest.raises(TypeError):
            getattr(presets, name)(compute_dtype="bfloat16")


def test_cli_accepts_the_new_presets():
    from veon_tpu_torch.cli.main import build_cfg, parser

    for name in ("veon_l", "veon_b_fast", "veon_b_fast2", "veon_b_zoe", "veon_l_zoe"):
        args = parser().parse_args(["serve", "--preset", name, "--num-temporal", "2"])
        cfg = build_cfg(args)
        assert cfg == getattr(presets, name)(num_temporal=2) and cfg.compute_dtype == "float32"


def _patch14(cfg):
    """The tiny preset with VEON-L's two traits: CLIP patch 14 on a grid it
    does not divide (the 32x88 CLIP input gives 2x6 tokens from a 3x3
    pretrain grid), and HSA blocks whose attention grid layer and added
    layer differ, (1, 2) / (2, 3)."""
    san = dataclasses.replace(cfg.san, clip_patch_size=14, clip_pretrain_grid=(3, 3))
    hsa = dataclasses.replace(cfg.hsa, fusion_map=((0, 1, 2), (1, 2, 3)))
    return dataclasses.replace(cfg, san=san, hsa=hsa)


def test_patch14_forward_from_converted_dumps_matches_reference(tmp_path):
    """Mirror dumps of the patch-14 config loaded by each side's
    `build_model_and_params` (JAX keeps the DA-V2 adapters unmerged, the
    port folds them), the full forward without a presorted lift on the
    example batch: outputs within 2e-4 (the slice's tolerance)."""
    from veon_tpu.cli import main as jmain
    from veon_tpu.cli.shapes import example_batch_full as jbatch
    from veon_tpu.model.veon import VeonModel as JaxModel
    from veon_tpu_torch.cli.main import build_model_and_params
    from veon_tpu_torch.cli.shapes import example_batch_full

    jcfg, pcfg = _patch14(jpresets.veon_tiny_test()), _patch14(presets.veon_tiny_test())
    paths = write_weights_dir(pcfg, str(tmp_path))
    model, _tower, ovw, _m, _e = build_model_and_params(pcfg, paths["san"], paths["depth"],
                                                        paths["bpe"], device="cpu")
    imgs, depth_imgs, metas = example_batch_full(pcfg, device="cpu")
    with torch.no_grad():
        got = model.full_forward(imgs, depth_imgs, metas, ovw)
    assert got["clip_feat"].shape[2:4] == (2, 6)
    saved = dict(jmain._INIT_MEMO)
    try:
        jm, variables, jovw, _refl, _ex = jmain._build_model_and_params(
            jcfg, san_ckpt=paths["san"], depth_ckpt=paths["depth"], bpe_path=paths["bpe"])
    finally:
        jmain._INIT_MEMO.clear()
        jmain._INIT_MEMO.update(saved)
    # the classifier, rows of norm exp(logit_scale) = 1 / 0.07: 1e-5 of a unit row
    np.testing.assert_allclose(to_np(ovw), np.asarray(jovw), rtol=0, atol=1e-5 / 0.07)
    ji, jd, jmetas = jbatch(jcfg, B=1)
    want = jax.jit(jm.apply, static_argnames=("train", "method"))(
        variables, ji, jd, jmetas, jovw, train=False, method=JaxModel.full_forward)
    for k in ("bin_occ", "feat_occ", "sem_occ_raw", "sem_seg_ds", "sem_embed_ds", "clip_feat"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=2e-4, atol=2e-4,
                                   err_msg=k)
