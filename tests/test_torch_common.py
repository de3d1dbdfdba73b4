"""Shared helpers for the PyTorch port's CPU tests (`tests/test_torch_*.py`):
the JAX reference at `veon_tiny_test` size with perturbed weights, and the
conversions that carry arrays between the two frameworks as numpy.

Also holds the port's import-hygiene tests: the port package,
`chip_smoke.py` and the mirror modules it imports import no JAX, flax or
`veon_tpu`, and neither `ml_dtypes` nor `sklearn`, which the card's
machine lacks; the port's C/C++ sources include nothing under `veon_tpu/`
and its build code names no source there.
"""

import ast
import dataclasses
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def to_torch(x):
    return torch.from_numpy(np.array(x, dtype=np.asarray(x).dtype))


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def np_tree(tree):
    """A flax variables tree as nested dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturbed(variables, seed=0):
    """Every leaf moved off its flax initial value (zero biases, unit norm
    scales, zero/unit BN stats would hide a wrong mapping): params get
    N(0, 0.1) noise, running means N(0, 0.1), running variances U(0.5, 1.5).
    The noise also spreads the tiny model's decisions: with init (key 1)
    and seed 0 a third of the voxels are occupied and >99% of them are
    clear of near-ties (the class-grid test's condition)."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in np_tree(variables).items():
        def walk(t, path=()):
            if isinstance(t, dict):
                return {k: walk(v, path + (k,)) for k, v in t.items()}
            if col == "batch_stats" and path[-1] == "var":
                return rng.uniform(0.5, 1.5, t.shape).astype(t.dtype)
            if col == "batch_stats":
                return (0.1 * rng.standard_normal(t.shape)).astype(t.dtype)
            return (t + 0.1 * rng.standard_normal(t.shape)).astype(t.dtype)
        out[col] = walk(tree)
    return out


@functools.lru_cache(maxsize=None)
def tiny_reference():
    """The JAX tiny model's full F=1 presorted LoRA-free forward with perturbed
    weights: dict(cfg, variables (numpy), imgs, depth_imgs, metas, ovw,
    refl, out), inputs as the port's example batch makes them."""
    from veon_tpu.cli.shapes import example_batch_full
    from veon_tpu.configs import presets
    from veon_tpu.geometry.frustum import sensor2keyego_chain
    from veon_tpu.lift.lss import LSSLift
    from veon_tpu.model.veon import VeonModel
    from veon_tpu.nn import text as text_mod

    cfg = presets.veon_tiny_test()
    # the serving graph runs LoRA-free (adapters folded into the base weights)
    cfg = dataclasses.replace(cfg, depth=dataclasses.replace(cfg.depth, use_lora=False))
    model = VeonModel(cfg=cfg)
    imgs, depth_imgs, metas = example_batch_full(cfg)
    prompts, refl = text_mod.build_vocabulary(cfg.vocabulary)
    ovw = jnp.asarray(np.random.default_rng(1).standard_normal(
        (len(prompts) + 1, cfg.san.clip_embed_dim)).astype(np.float32))
    N = metas["sensor2egos"].shape[2]
    s2k = sensor2keyego_chain(metas["sensor2egos"].reshape(1, -1, 4, 4),
                              metas["ego2globals"].reshape(1, -1, 4, 4), 1, N)
    metas = dict(metas)
    metas["lift_sorted"] = LSSLift.from_config(cfg).precompute_sorted(
        s2k[:, 0], metas["intrins"][:, 0], metas["post_rots"][:, 0],
        metas["post_trans"][:, 0], metas["bda"])
    init = jax.jit(model.init, static_argnames=("train", "method"))
    variables = perturbed(init(jax.random.PRNGKey(1), imgs, depth_imgs, metas, ovw,
                               train=False, method=VeonModel.full_forward))
    apply = jax.jit(model.apply, static_argnames=("train", "method"))
    out = apply(variables, imgs, depth_imgs, metas, ovw, train=False,
                method=VeonModel.full_forward)
    return dict(cfg=cfg, variables=variables, imgs=imgs, depth_imgs=depth_imgs,
                metas=metas, ovw=ovw, refl=refl, out={k: np.asarray(v) for k, v in out.items()})


def port_tiny_cfg():
    from veon_tpu_torch.configs import presets

    return presets.veon_tiny_test()


def close_per_leaf(got, want, what, zero_up_to_rounding=()):
    """Each gradient within 1e-4 of its own largest entry; the leaves in
    `zero_up_to_rounding` (biases in front of a train-mode BatchNorm, whose
    gradient is 0 but for rounding) within 1e-4 of the largest entry of
    the whole set."""
    scale = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        own = scale if n in zero_up_to_rounding else np.abs(w).max()
        assert own > 0, n
        np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-4 * own, err_msg=f"{what} {n}")


def zero_grad_biases(model):
    """Names of the biases whose gradient is 0 but for rounding: a conv
    bias in front of a train-mode BatchNorm (the batch mean takes it out),
    and the deformable attention's `key_value_proj.bias` (its key half
    shifts every sample's logit by the same q . b, since each sample's hat
    weights sum to 1; its value half shifts the output by a constant that
    `final_norm` takes out) and `out_proj.bias`."""
    out = set()
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if hasattr(mod, "conv") and hasattr(mod, "bn") and mod.conv.bias is not None:
            out.add(f"{pre}conv.bias")
        if hasattr(mod, "final_norm"):
            out |= {f"{pre}out_proj.bias", f"{pre}key_value_proj.bias"}
    return out


_BANNED = ("jax", "flax", "veon_tpu", "ml_dtypes", "sklearn")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_flax_or_reference():
    """Nor anything else in _BANNED; nor do the two test modules that
    `chip_smoke.py` imports on the card (the reference-layout mirrors)."""
    files = sorted((REPO / "veon_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_mirror.py",
        REPO / "tests" / "ref_layout_mirror.py"]
    assert len(files) > 10
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in _BANNED]
    assert not bad, bad


def test_port_native_sources_stand_alone():
    """Every `#include "..."` of the port's C/C++ sources resolves inside
    `veon_tpu_torch/csrc/`, no `#include <...>` names `veon_tpu`, and the
    build code (`ops/native.py`, `data/native.py`) holds no path into the
    JAX package (no path-like string constant names it)."""
    csrc = REPO / "veon_tpu_torch" / "csrc"
    files = sorted(p for p in csrc.rglob("*") if p.suffix in (".h", ".cuh", ".cpp", ".cu"))
    assert len(files) >= 8, files
    for p in files:
        for quote, inc in re.findall(r'#\s*include\s*([<"])([^>"]+)[>"]', p.read_text()):
            assert "veon_tpu" not in inc.split("/")[0], (p.name, inc)
            if quote == '"':
                target = (p.parent / inc).resolve()
                assert target.is_file() and csrc in target.parents, (p.name, inc)
    for rel in ("ops/native.py", "data/native.py"):
        tree = ast.parse((REPO / "veon_tpu_torch" / rel).read_text())
        consts = [n.value for n in ast.walk(tree)  # path-like strings, not prose
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)
                  and not re.search(r"\s", n.value)]
        bad = [c for c in consts if c == "veon_tpu" or re.search(r"veon_tpu[/\\]", c)]
        assert not bad, (rel, bad)
