"""Shared helpers for the PyTorch port's CPU tests (`tests/test_torch_*.py`):
the JAX reference at `veon_tiny_test` size with perturbed weights, and the
conversions that carry arrays between the two frameworks as numpy.

Also holds the port's import-hygiene test: the port package and
`chip_smoke.py` import no JAX, flax or `veon_tpu`.
"""

import ast
import dataclasses
import functools
import pathlib

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


_BANNED = ("jax", "flax", "veon_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_flax_or_reference():
    files = sorted((REPO / "veon_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in _BANNED]
    assert not bad, bad
