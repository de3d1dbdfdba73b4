"""Activation-parity comparator for weights day (counterpart of
`veon_tpu/parity/compare.py`): replays a reference dump (written by the
JAX package's standalone `parity/dump_reference.py` inside the reference's
torch environment) through the port's converted-weight model and checks
every module boundary within its tolerance, so checking real checkpoints
is mechanical: convert -> `veon_tpu_torch parity --dumps <dir>` -> read
the table.

F>1 (temporal) dumps get a per-frame table: the reference packs frames
into the B*N*F camera axis cam-major, frame 0 current
(`split_image_style_tensors`, `san_in_veon_temporal.py:315-319`), and its
per-frame modules (hsa, rec_update, lift, occ_early) fire once per frame,
previous frames first and the current frame last, as the port's do, so
call j maps to call j. Per-frame boundaries carry `@p<i>` for previous
frame i (1-based); the bare name is the current frame. The single-call
boundaries (CLIP trunk, side adapter, rec head) run over all frames on
the reference side and are sliced to the current frame.

Layout adapters (reference torch layout -> the port's):
  images / features  NCHW -> NHWC
  CLIP tokens        {k: (BN,C,h,w), "k_cls_token": (1,BN,C)}
                     -> {"k": (BN,h,w,C), "k_cls": (BN,1,C)}
  3D grids           (B,C,Z,Y,X) -> (B,Z,Y,X,C)
  HSA attn bias      the reference materializes it dense, (A,B,heads,L,L)
                     (`highres_side_adaptor.py:182`); the port returns
                     the factors (A,B,L,heads,dh), densified here

Metrics per boundary: the cosine over the flattened pair and the largest
error relative to the reference's largest magnitude, in numpy, as JAX's.
The port's side is captured by forward hooks on the model's submodules
(`run_boundaries`). `Tol`, `BOUNDARIES`, `_metrics`, `load_dumps`,
`reference_boundaries` and `format_report` are the JAX module's numpy as
it is.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Tol:
    cos_min: float = 0.999
    rel_max: float = 5e-3


# boundary name -> default tolerance. Early boundaries (one module deep)
# are tight; the 3D stage accumulates (lift scatter + BN + trilinear).
BOUNDARIES: Dict[str, Tol] = {
    "depth_pred": Tol(0.999, 1e-2),
    "zoe_rel_depth": Tol(0.999, 1e-2),
    "occ_early": Tol(0.998, 2e-2),
    "clip_tokens": Tol(0.9995, 5e-3),
    "sa_mask_preds": Tol(0.999, 1e-2),
    "sa_attn_bias": Tol(0.999, 1e-2),
    "rec_mask_embs": Tol(0.999, 1e-2),
    "rec_update_proj": Tol(0.999, 1e-2),
    "hsa_attn_dense": Tol(0.999, 1e-2),
    "hsa_supp": Tol(0.999, 1e-2),
    "lift_fused_2d": Tol(0.998, 2e-2),
    "lift_vox": Tol(0.998, 2e-2),
    "occ_bin": Tol(0.995, 5e-2),
    "occ_feat": Tol(0.995, 5e-2),
    "out_sem_seg_ds": Tol(0.995, 5e-2),
    "out_sem_embed_ds": Tol(0.995, 5e-2),
    "out_clip_feat": Tol(0.995, 5e-2),
    "out_bin_occ": Tol(0.995, 5e-2),
    "out_feat_occ": Tol(0.995, 5e-2),
}


def _metrics(ref: np.ndarray, got: np.ndarray):
    ref = np.asarray(ref, np.float32).reshape(-1)
    got = np.asarray(got, np.float32).reshape(-1)
    denom = float(np.linalg.norm(ref) * np.linalg.norm(got))
    cos = float(ref @ got / denom) if denom > 0 else 1.0
    scale = float(np.abs(ref).max())
    rel = float(np.abs(ref - got).max() / (scale + 1e-12))
    return cos, rel


def load_dumps(dumps_dir: str):
    inputs = dict(np.load(os.path.join(dumps_dir, "inputs.npz")))
    boundaries = dict(np.load(os.path.join(dumps_dir, "boundaries.npz")))
    manifest = {}
    mpath = os.path.join(dumps_dir, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
    return inputs, boundaries, manifest


def batch_from_inputs(inputs: Dict[str, np.ndarray], num_cams: int = 6, device="cuda"):
    """The dump's inputs -> (the port's frame-major (B, F, N, ...) batch as
    fp32 tensors on `device`, channel-last images, F).

    The dump's camera axis is (N, F) cam-major, frame 0 current
    (`split_image_style_tensors` reshapes (B, n_cam, N_T, ...)), the port's
    frame-major: unpack (B, N, F) then swap. F=1 is the same either way."""
    imgs = inputs["imgs"]  # (B, N*F, 3, H, W) cam-major
    B, FN = imgs.shape[:2]
    F = FN // num_cams
    N = num_cams

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)

    def cams(x, trailing):
        x = x.reshape((B, N, F) + x.shape[2:][:trailing])
        return dev(np.swapaxes(x, 1, 2))

    batch = {
        "imgs": dev(imgs.reshape(B, N, F, *imgs.shape[2:]).transpose(0, 2, 1, 4, 5, 3)),
        "depth": cams(inputs["depth"], 2),
        "metas": {
            "sensor2egos": cams(inputs["sensor2egos"], 2),
            "ego2globals": cams(inputs["ego2globals"], 2),
            "intrins": cams(inputs["intrins"], 2),
            "post_rots": cams(inputs["post_rots"], 2),
            "post_trans": cams(inputs["post_trans"], 1),
            "bda": dev(inputs["bda"]),
        },
    }
    if "adj_meta_0" in inputs:
        batch["metas"]["lidarego2global"] = dev(inputs["adj_meta_0"])
    prevs = []
    i = 1
    while f"adj_meta_{i}" in inputs:
        prevs.append(inputs[f"adj_meta_{i}"])
        i += 1
    if prevs:
        batch["metas"]["prev_lidarego2global"] = dev(np.stack(prevs, axis=1))
    if "depth_imgs_flat" in inputs:
        d = inputs["depth_imgs_flat"]  # (B*N*F, 3, Hd, Wd) cam-major
        batch["depth_imgs"] = dev(d.reshape(B, N, F, *d.shape[1:]).transpose(0, 2, 1, 4, 5, 3))
    return batch, F


def _densify_hsa(factors: torch.Tensor) -> np.ndarray:
    """(A, B, L, heads, dh) factors -> dense (A, B, heads, L, L) bias
    (`highres_side_adaptor.py:182`: bias = f @ f^T per attn layer/head),
    in fp32 on the factors' device (at VEON-B 0.86 GB per frame)."""
    f = factors.detach().float()
    return _np(torch.einsum("ablhd,abmhd->abhlm", f, f))


def _frame_tag(j: int, n_calls: int) -> str:
    """Per-frame key suffix: calls run prev frames first (f=1..F-1), the
    current frame LAST — bare name for current, `@p<i>` for previous i."""
    return "" if j == n_calls - 1 else f"@p{j + 1}"


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _capture(model, names):
    """(calls {name: [outputs]}, undo): forward hooks on the named
    submodules, plus wrappers of `rec_head.update_remaining` (a method, not
    `forward`) and the model's `_early_vox` (one lifted frame per call,
    the counterpart of JAX's `early_vox_frames` sow), each call's output
    kept in call order."""
    calls = {n: [] for n in names + ("update_remaining", "early_vox")}
    handles = [getattr(model, n).register_forward_hook(
        lambda _m, _a, out, n=n: calls[n].append(out)) for n in names]

    def wrap(owner, attr, key, pick):
        inner = getattr(owner, attr)

        def call(*a, **k):
            out = inner(*a, **k)
            calls[key].append(pick(out))
            return out

        setattr(owner, attr, call)
        return lambda: delattr(owner, attr)

    undo = [wrap(model.rec_head, "update_remaining", "update_remaining",
                 lambda o: o["clip_feat_proj"]),
            wrap(model, "_early_vox", "early_vox", lambda o: o[0])]

    def close():
        for h in handles:
            h.remove()
        for u in undo:
            u()

    return calls, close


def run_boundaries(model, batch, ov_weight) -> Dict[str, np.ndarray]:
    """The model's forward (eval mode, no gradient) with the boundary
    modules' outputs captured, as numpy fp32 in the port's layouts
    (counterpart of `run_jax_boundaries`). Per-frame modules (hsa,
    rec_update, lift) fire once per frame; their previous-frame calls get
    `@p<i>` keys (F=1 gives exactly the bare-name table)."""
    names = ("clip_visual", "side_adapter", "rec_head", "hsa", "lift_fusion", "alignnet")
    calls, close = _capture(model, names)
    try:
        with torch.no_grad():
            out = model(batch["imgs"], batch["depth"], batch["metas"], ov_weight,
                        return_early_vox=True)
    finally:
        close()
    got: Dict[str, np.ndarray] = {}
    for c in calls["clip_visual"]:
        for k, v in c.items():
            got[f"clip_tokens.{k}"] = _np(v)
    for mask_preds, attn_bias, _ in calls["side_adapter"]:
        got["sa_mask_preds"] = _np(mask_preds)
        got["sa_attn_bias"] = _np(attn_bias)
    for c in calls["rec_head"]:
        got["rec_mask_embs"] = _np(c)
    upd = calls["update_remaining"]
    for j, c in enumerate(upd):
        got[f"rec_update_proj{_frame_tag(j, len(upd))}"] = _np(c)
    hsa = calls["hsa"]
    for j, (factors, supp) in enumerate(hsa):
        tag = _frame_tag(j, len(hsa))
        got[f"hsa_attn_dense{tag}"] = _densify_hsa(factors)
        got[f"hsa_supp{tag}"] = _np(supp)
    lf = calls["lift_fusion"]
    for j, c in enumerate(lf):
        got[f"lift_fused_2d{_frame_tag(j, len(lf))}"] = _np(c)
    for c in calls["alignnet"]:
        got["occ_bin"] = _np(c["bin_occ"])
        got["occ_feat"] = _np(c["feat_occ"])
    vox = calls["early_vox"]
    for j, v in enumerate(vox):
        tag = _frame_tag(j, len(vox))
        got[f"lift_vox{tag}"] = _np(v)
        if tag:
            got[f"occ_early{tag}"] = _np(v)
    for k in ("sem_seg_ds", "sem_embed_ds", "clip_feat", "bin_occ", "feat_occ"):
        got[f"out_{k}"] = _np(out[k])
    return got


def _nchw(x):
    return x.transpose(0, 2, 3, 1)


def reference_boundaries(bnd: Dict[str, np.ndarray], B: int = 1, F: int = 1,
                         num_cams: int = 6) -> Dict[str, np.ndarray]:
    """Torch dump keys/layouts -> comparator keys in this repo's layouts.

    Keys follow dump_reference.py's flattener: "<boundary>#<call>/<path>".
    Per-frame modules fire once per frame, previous frames first and the
    current frame LAST (`san_in_veon_temporal.py:158-173`) — call j gets
    the same `@p<i>`/bare tag as the jax side. Single-call boundaries run
    over all B*N*F frames cam-major; the current frame is sliced out
    (this model runs the decode on the current frame only).
    """
    ref: Dict[str, np.ndarray] = {}

    def cur(x):
        """(B*N*F, ...) cam-major -> current-frame (B*N, ...)."""
        if F == 1 or x.shape[0] != B * num_cams * F:
            return x
        bn = B * num_cams
        return x.reshape((B, num_cams, F) + x.shape[1:])[:, :, 0] \
                .reshape((bn,) + x.shape[1:])

    def frame_major(x, axis=0):
        """(..., B*N*F, ...) cam-major -> frame-major (this model's CLIP
        trunk runs ALL frames in one flattened (B, F, N) pass)."""
        if F == 1 or x.shape[axis] != B * num_cams * F:
            return x
        x = np.moveaxis(x, axis, 0)
        x = x.reshape((B, num_cams, F) + x.shape[1:])
        x = np.swapaxes(x, 1, 2).reshape((B * F * num_cams,) + x.shape[3:])
        return np.moveaxis(x, 0, axis)

    def all_calls(prefix):
        idxs = {int(k.split("#")[1].split("/")[0])
                for k in bnd if k.startswith(prefix + "#")}
        return sorted(idxs)

    def last_call(prefix):
        idxs = all_calls(prefix)
        return idxs[-1] if idxs else None

    c = last_call("clip_tokens")
    if c is not None:
        for k, v in bnd.items():
            if not k.startswith(f"clip_tokens#{c}/"):
                continue
            sub = k.split("/", 1)[1]
            if sub.endswith("_cls_token"):
                ref[f"clip_tokens.{sub[:-10]}_cls"] = frame_major(
                    v.transpose(1, 0, 2))
            else:
                ref[f"clip_tokens.{sub}"] = frame_major(_nchw(v))
    c = last_call("side_adapter")
    if c is not None:
        # (mask_preds list, attn_biases list-of-list, san_features): eval
        # mode emits a single deep-supervision stage (decode_masks,
        # side_adaptor_in_veon.py:181-192)
        mp = [k for k in bnd if k.startswith(f"side_adapter#{c}/0/")]
        if mp:
            ref["sa_mask_preds"] = cur(bnd[sorted(mp)[-1]])
        ab = [k for k in bnd if k.startswith(f"side_adapter#{c}/1/")]
        if ab:
            ref["sa_attn_bias"] = cur(bnd[sorted(ab)[-1]])
    c = last_call("rec_mask_embs")
    if c is not None:
        ref["rec_mask_embs"] = cur(bnd[f"rec_mask_embs#{c}"])
    hsa_calls = all_calls("hsa")
    for j, c in enumerate(hsa_calls):
        tag = _frame_tag(j, len(hsa_calls))
        # (offsets, attns, supp); attns dense (A,B,heads,L,L); supp is the
        # LAST entry of the supp list (the consumed one)
        att = sorted(k for k in bnd if k.startswith(f"hsa#{c}/1/"))
        if att:
            ref[f"hsa_attn_dense{tag}"] = np.stack([bnd[k] for k in att]) \
                if bnd[att[0]].ndim == 4 else bnd[att[-1]]
        supp = sorted(k for k in bnd if k.startswith(f"hsa#{c}/2/"))
        if supp:
            ref[f"hsa_supp{tag}"] = _nchw(bnd[supp[-1]])
        elif f"hsa#{c}/2" in bnd:
            ref[f"hsa_supp{tag}"] = _nchw(bnd[f"hsa#{c}/2"])
    lift_calls = all_calls("lift")
    for j, c in enumerate(lift_calls):
        v = bnd[f"lift#{c}"] if f"lift#{c}" in bnd else bnd.get(f"lift#{c}/0")
        if v is not None and v.ndim == 5:  # (B, C, Z, Y, X)
            ref[f"lift_vox{_frame_tag(j, len(lift_calls))}"] = \
                v.transpose(0, 2, 3, 4, 1)
    for tid in all_calls("occ_early"):
        # forward_early returns fuse(0, ...) == the lift output for that
        # previous frame, PRE ego-align (align_net_occ3d.py:268-280 + the
        # wrap in dump_reference.py) — previous frames only
        v = bnd[f"occ_early#{tid}"] if f"occ_early#{tid}" in bnd \
            else bnd.get(f"occ_early#{tid}/0")
        if v is not None and v.ndim == 5:
            ref[f"occ_early@p{tid + 1}"] = v.transpose(0, 2, 3, 4, 1)
    upd_calls = all_calls("rec_update")
    for j, c in enumerate(upd_calls):
        v = bnd.get(f"rec_update#{c}/clip_feat_proj")
        if v is not None and v.ndim == 4:  # (BN, C, h, w)
            ref[f"rec_update_proj{_frame_tag(j, len(upd_calls))}"] = _nchw(v)
    c = last_call("zoe_core")
    if c is not None:
        # MidasCore(x, return_rel_depth=True) -> (rel_depth, features); the
        # rel-depth trunk boundary localizes zoe trunk-vs-bins mismatches
        v = bnd.get(f"zoe_core#{c}/0")
        if v is not None:
            ref["zoe_rel_depth"] = v
    c = last_call("occ_heads")
    if c is not None:
        for name, key in (("occ_bin", "bin_occ"), ("occ_feat", "feat_occ")):
            v = bnd.get(f"occ_heads#{c}/{key}")
            if v is not None:
                ref[name] = v.transpose(0, 2, 3, 4, 1)
    c = last_call("outputs")
    if c is not None:
        for name in ("sem_seg_ds", "sem_embed_ds", "clip_feat"):
            v = bnd.get(f"outputs#{c}/{name}")
            if v is not None:  # (B, N, C, h, w) -> (B, N, h, w, C)
                ref[f"out_{name}"] = v.transpose(0, 1, 3, 4, 2)
        for name in ("bin_occ", "feat_occ"):
            v = bnd.get(f"outputs#{c}/{name}")
            if v is not None:  # (B, C, Z, Y, X) -> (B, Z, Y, X, C)
                ref[f"out_{name}"] = v.transpose(0, 2, 3, 4, 1)
    return ref


def compare_dumps(
    dumps_dir: str,
    model,
    tol_overrides: Optional[Dict[str, Tol]] = None,
    num_cams: int = 6,
    log: Callable[[str], None] = print,
) -> List[Dict]:
    """A row per compared boundary: {boundary, cos, rel, cos_min, rel_max,
    ok, shape}; boundaries on one side only get ok None. The inputs go to
    the model's device; the model runs in its own dtype."""
    inputs, bnd, _manifest = load_dumps(dumps_dir)
    device = next(model.parameters()).device
    batch, F = batch_from_inputs(inputs, num_cams=num_cams, device=device)
    # the dumped classifier weight makes the visual path self-contained
    # (text-encoder parity is covered by its own tests)
    ovw = None
    for k, v in bnd.items():
        if k.endswith("/ov_classifier_weight"):
            ovw = torch.from_numpy(np.asarray(v, np.float32)).to(device)
    if ovw is None:
        raise SystemExit(
            "dump has no ov_classifier_weight (outputs boundary) — "
            "re-dump with the stock dump_reference.py")

    B = int(inputs["imgs"].shape[0])
    ref = reference_boundaries(bnd, B=B, F=F, num_cams=num_cams)
    got = run_boundaries(model, batch, ovw)
    if "depth_imgs" in batch and "depth" in inputs:
        rel = []
        hook = (model.depth.core.register_forward_hook(lambda _m, _a, out: rel.append(out[0]))
                if "zoe_rel_depth" in ref else None)
        try:
            with torch.no_grad():
                got["depth_pred"] = _np(model.estimate_depth(batch["depth_imgs"]))
        finally:
            if hook is not None:
                hook.remove()
        if rel:
            got["zoe_rel_depth"] = _np(rel[-1])
        # (B, N*F, h2, w2) cam-major -> (B, F, N, h2, w2)
        d = inputs["depth"]
        d = d.reshape(B, num_cams, F, *d.shape[2:])
        ref["depth_pred"] = np.swapaxes(d, 1, 2)
        if "zoe_rel_depth" in ref and "zoe_rel_depth" in got:
            z = ref["zoe_rel_depth"]  # (B*N*F, H, W) cam-major
            z = z.reshape(B, num_cams, F, *z.shape[1:])
            ref["zoe_rel_depth"] = np.swapaxes(z, 1, 2).reshape(
                got["zoe_rel_depth"].shape)

    tols = dict(BOUNDARIES)
    tols.update(tol_overrides or {})
    rows = []
    for name in sorted(set(ref) & set(got)):
        base = name.split("@")[0].split(".")[0]
        tol = tols.get(name, tols.get(base, Tol()))
        r, g = ref[name], got[name]
        if r.shape != g.shape:
            rows.append({"boundary": name, "ok": False,
                         "error": f"shape {r.shape} vs {g.shape}"})
            continue
        cos, rel = _metrics(r, g)
        rows.append({"boundary": name, "cos": cos, "rel": rel,
                     "cos_min": tol.cos_min, "rel_max": tol.rel_max,
                     "shape": list(g.shape),
                     "ok": cos >= tol.cos_min and rel <= tol.rel_max})
    skipped = sorted(set(ref) ^ set(got))
    for name in skipped:
        side = "dump" if name in ref else "port"
        rows.append({"boundary": name, "ok": None,
                     "error": f"only on the {side} side — skipped"})
    return rows


def format_report(rows: List[Dict]) -> str:
    lines = [f"{'boundary':<26} {'cos':>10} {'>=':>8} {'rel':>10} "
             f"{'<=':>8}  verdict"]
    for r in rows:
        if r["ok"] is None:
            lines.append(f"{r['boundary']:<26} {'-':>10} {'-':>8} {'-':>10} "
                         f"{'-':>8}  SKIP ({r['error']})")
        elif "error" in r:
            lines.append(f"{r['boundary']:<26} {'-':>10} {'-':>8} {'-':>10} "
                         f"{'-':>8}  FAIL ({r['error']})")
        else:
            lines.append(
                f"{r['boundary']:<26} {r['cos']:>10.6f} {r['cos_min']:>8} "
                f"{r['rel']:>10.4g} {r['rel_max']:>8}  "
                f"{'ok' if r['ok'] else 'FAIL'}")
    n_fail = sum(1 for r in rows if r["ok"] is False)
    n_ok = sum(1 for r in rows if r["ok"])
    lines.append(f"{n_ok} ok / {n_fail} failed / "
                 f"{sum(1 for r in rows if r['ok'] is None)} skipped")
    return "\n".join(lines)
