"""The port's weights-day parity comparator (`veon_tpu_torch/parity`, the
`parity` CLI) on synthetic reference dumps, the cases of
`tests/test_parity_harness.py`, fp32 on the CPU.

Each dump is built from the tiny JAX graph with the inverse layout
adapters of that test (`_torchify`, `_torchify_t`): the JAX model built by
the JAX CLI from reference-layout checkpoint files (`test_torch_mirror.py`
`write_weights_dir`), the port's by the port's CLI from the same files, so
both sides share the weights as they will on weights day. The port's
comparator is green on a faithful dump at F=1, T=2 and on the zoe branch
(cos >= 0.995-0.9995, rel <= 5e-3-5e-2 per boundary, the JAX table's), red
on a corrupted boundary and on a corrupted previous frame, its tolerance
table covers every boundary it emits, and the CLI exits 1 on a failed row.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_parity_harness import _pack_cam_major, _torchify, _torchify_t
from test_torch_common import to_torch
from test_torch_mirror import with_tiny_zoe, write_weights_dir

from veon_tpu.cli import main as jcli
from veon_tpu.configs import presets as jpresets
from veon_tpu.parity.compare import run_jax_boundaries

from veon_tpu_torch.cli import main as pcli
from veon_tpu_torch.configs import presets
from veon_tpu_torch.parity.compare import BOUNDARIES, compare_dumps, format_report, run_boundaries


def _write(d, inputs, bnd):
    d.mkdir()
    np.savez(d / "inputs.npz", **inputs)
    np.savez(d / "boundaries.npz", **bnd)
    (d / "manifest.json").write_text(json.dumps(
        {"boundaries": sorted({k.split("#")[0] for k in bnd})}))
    return str(d)


def _sides(jcfg, pcfg, root):
    """(JAX model, JAX variables, port model) from one weights dir."""
    paths = write_weights_dir(pcfg, root)
    jmodel, jvars, *_ = jcli._build_model_and_params(
        jcfg, san_ckpt=paths["san"], depth_ckpt=paths["depth"], bpe_path=paths["bpe"])
    pmodel = pcli.build_model_and_params(pcfg, paths["san"], paths["depth"], paths["bpe"],
                                         device="cpu")[0]
    return jmodel, jvars, pmodel


def _inputs(g, B, F, N):
    imgs, depth = np.asarray(g["imgs"]), np.asarray(g["depth"])
    m = {k: np.asarray(v) for k, v in g["metas"].items()}
    out = {"imgs": _pack_cam_major(imgs, B, F, N).transpose(0, 1, 4, 2, 3),
           "depth": _pack_cam_major(depth, B, F, N), "bda": m["bda"]}
    for k in ("sensor2egos", "ego2globals", "intrins", "post_rots", "post_trans"):
        out[k] = _pack_cam_major(m[k], B, F, N)
    if F > 1:
        out["adj_meta_0"] = m["lidarego2global"]
        for i in range(1, F):
            out[f"adj_meta_{i}"] = m["prev_lidarego2global"][:, i - 1]
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=["F1", "T2"])
def dump(request, tiny_graph, tmp_path_factory):
    """(dump dir, port model, the JAX side's boundaries) at F frames."""
    F, B, N = request.param, 1, 6
    g = tiny_graph(F)
    root = tmp_path_factory.mktemp(f"weights_f{F}")
    jmodel, jvars, pmodel = _sides(jpresets.veon_tiny_test(num_temporal=F),
                                   presets.veon_tiny_test(num_temporal=F), str(root))
    jax_side = run_jax_boundaries(jmodel, jvars, {"imgs": g["imgs"], "depth": g["depth"],
                                                  "metas": g["metas"]}, g["ovw"])
    bnd = {"outputs#0/ov_classifier_weight": np.asarray(g["ovw"])}
    for name, arr in jax_side.items():
        bnd.update(_torchify(name, arr) if F == 1 else _torchify_t(name, arr, B, N, F))
    d = _write(tmp_path_factory.mktemp(f"dump_f{F}") / "d", _inputs(g, B, F, N), bnd)
    return dict(dir=d, root=str(root), model=pmodel, jax_side=jax_side, F=F)


def test_comparator_green_on_faithful_dump(dump):
    """Every boundary on both sides is within its tolerance, the semantic
    ones among them (at T=2 the previous frame's too), and the port emits
    each boundary the JAX side does."""
    rows = compare_dumps(dump["dir"], dump["model"])
    report = format_report(rows)
    by = {r["boundary"]: r for r in rows}
    compared = [r for r in rows if r["ok"] is not None]
    assert compared and all(r["ok"] for r in compared), report
    must = ["sa_mask_preds", "rec_mask_embs", "hsa_supp", "hsa_attn_dense", "lift_vox",
            "occ_bin", "out_feat_occ", "rec_update_proj"]
    if dump["F"] == 2:
        must += ["lift_vox@p1", "occ_early@p1", "hsa_attn_dense@p1", "hsa_supp@p1",
                 "rec_update_proj@p1"]
    for m in must:
        assert by.get(m, {}).get("ok"), (m, report)
    assert any(b.startswith("clip_tokens.") and by[b]["ok"] for b in by), report
    # the reference dumps no fused 2D lift input: the port's side alone
    skipped = {r["boundary"] for r in rows if r["ok"] is None}
    assert skipped and all(b.startswith("lift_fused_2d") for b in skipped), report


def test_comparator_red_on_corrupted_boundary(dump, tmp_path):
    """A corrupted boundary fails alone: at F=1 the rec head's embeddings
    (an unrelated boundary still passes), at T=2 the previous frame's lift
    (the current frame's still passes)."""
    bnd = dict(np.load(dump["dir"] + "/boundaries.npz"))
    key, bad, good = (("rec_mask_embs#0", "rec_mask_embs", "sa_mask_preds") if dump["F"] == 1
                      else ("lift#0", "lift_vox@p1", "lift_vox"))
    bnd[key] = bnd[key] + 0.5 * np.abs(bnd[key]).max() + 1.0
    d2 = tmp_path / "corrupt"
    shutil.copytree(dump["dir"], d2)
    np.savez(d2 / "boundaries.npz", **bnd)
    rows = compare_dumps(str(d2), dump["model"])
    by = {r["boundary"]: r for r in rows}
    assert by[bad]["ok"] is False, format_report(rows)
    assert by[good]["ok"], format_report(rows)
    assert sum(r["ok"] is False for r in rows) == 1, format_report(rows)


def test_tolerance_table_covers_all_emitted_boundaries(dump, tiny_graph):
    """Every boundary `run_boundaries` emits has a default tolerance, and it
    emits the JAX side's keys and shapes."""
    g = tiny_graph(dump["F"])
    batch = {"imgs": to_torch(g["imgs"]), "depth": to_torch(g["depth"]),
             "metas": {k: to_torch(v) for k, v in g["metas"].items()}}
    got = run_boundaries(dump["model"], batch, to_torch(g["ovw"]))
    assert set(got) == set(dump["jax_side"])
    for name, arr in got.items():
        assert arr.shape == np.asarray(dump["jax_side"][name]).shape, name
        base = name.split("@")[0].split(".")[0]
        assert base in BOUNDARIES or name in BOUNDARIES, f"no default tolerance for {name}"


def test_parity_cli_exit_codes(dump, tmp_path, capsys):
    """`parity --weights-dir` returns the rows on a faithful dump, exits 1
    naming the corrupted row alone, exits 1 against seeded weights (with
    the warning), and refuses to run without --dumps."""
    argv = ["parity", "--preset", "veon_tiny_test", "--num-temporal", str(dump["F"]),
            "--device", "cpu"]
    rows = pcli.main(argv + ["--dumps", dump["dir"], "--weights-dir", dump["root"]])
    assert rows and all(r["ok"] is not False for r in rows)
    out = capsys.readouterr().out
    assert " 0 failed" in out and "dump " in out and "peak host memory" in out
    bnd = dict(np.load(dump["dir"] + "/boundaries.npz"))
    bnd["occ_heads#0/bin_occ"] = bnd["occ_heads#0/bin_occ"] * 1.5 + 1.0
    d2 = tmp_path / "corrupt"
    shutil.copytree(dump["dir"], d2)
    np.savez(d2 / "boundaries.npz", **bnd)
    with pytest.raises(SystemExit) as e:
        pcli.main(argv + ["--dumps", str(d2), "--weights-dir", dump["root"]])
    assert e.value.code == 1
    failed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()
              if ln.endswith("FAIL")]
    assert failed == ["occ_bin"]
    with pytest.raises(SystemExit) as e:
        pcli.main(argv + ["--dumps", dump["dir"]])
    assert e.value.code == 1 and "RANDOM init" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--dumps"):
        pcli.main(argv)


def test_comparator_zoe_depth_leg(tiny_graph, tmp_path):
    """A zoe dump with depth_imgs and the MiDaS core's relative depth: the
    comparator checks the metric depth and the trunk's relative depth
    besides the semantic boundaries, all green."""
    g = tiny_graph(1)
    B, F, N = 1, 1, 6
    jcfg, pcfg = with_tiny_zoe(jpresets.veon_tiny_test()), with_tiny_zoe(presets.veon_tiny_test())
    jmodel, jvars, pmodel = _sides(jcfg, pcfg, str(tmp_path / "w"))
    dh, dw = jcfg.data.depth_input_size
    depth_imgs = jnp.asarray(np.random.default_rng(1).standard_normal(
        (B, F, N, dh, dw, 3)).astype(np.float32))
    dp, state = jax.jit(jmodel.apply, static_argnames=("method", "capture_intermediates",
                                                       "mutable"))(
        jvars, depth_imgs, method="estimate_depth",
        capture_intermediates=lambda m, _: getattr(m, "name", None) == "core",
        mutable=("intermediates",))
    rel = [np.asarray(c[0] if isinstance(c, tuple) else c)
           for node in jax.device_get(state["intermediates"]).values()
           if isinstance(node, dict) and "core" in node for c in node["core"]["__call__"]]
    jax_side = run_jax_boundaries(jmodel, jvars, {"imgs": g["imgs"], "depth": dp,
                                                  "metas": g["metas"]}, g["ovw"])
    bnd = {"outputs#0/ov_classifier_weight": np.asarray(g["ovw"]), "zoe_core#0/0": rel[-1]}
    for name, arr in jax_side.items():
        bnd.update(_torchify(name, arr))
    inputs = _inputs(dict(g, depth=dp), B, F, N)
    inputs["depth_imgs_flat"] = np.asarray(depth_imgs).reshape(B * F * N, dh, dw, 3) \
        .transpose(0, 3, 1, 2)
    rows = compare_dumps(_write(tmp_path / "zoe_dump", inputs, bnd), pmodel)
    report = format_report(rows)
    by = {r["boundary"]: r for r in rows}
    for must in ("depth_pred", "zoe_rel_depth", "lift_vox", "out_feat_occ", "rec_mask_embs"):
        assert by.get(must, {}).get("ok"), (must, report)
    assert all(r["ok"] for r in rows if r["ok"] is not None), report
