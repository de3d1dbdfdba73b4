"""Deployment export (counterpart of `veon_tpu/utils/export.py`, the
reference's `tools/convert_bevdet_to_TRT.py`): the serving graph frozen by
`torch.export` into a `.pt2` program that a server (`serve/server.py`
`serve_exported`), the artifact benchmark (`cli/main.py` `benchmark
--artifact`) or another process loads and runs without the model's Python
code.

The weights live inside the program; the frames, the rig metas (with the
fixed rig's presorted lift, "lift_sorted"), the open-vocabulary matrix and,
for the streaming step, the temporal cache and the text embedding are its
inputs, as in JAX's artifacts; a dict input keeps the key order it was
exported with (`torch.export` flattens dicts in order). Kernels #1-#3 stay in the graph as the
registered operators of `ops/bev_pool.py` (`torch.ops.veon.*`), so a
`.pt2` loads only where `veon_tpu_torch` imports; `load_inference` imports
them. A program runs on the device it was exported on.

    export_flagship("work_dir/veon_infer.pt2")          # veon_b F=1, bf16
    export_streaming("work_dir/veon_infer_t2.pt2", "veon_b", 2, raw_uint8=True)
    program = load_inference("work_dir/veon_infer.pt2")
    grid = program(imgs, depth_imgs, metas, ov_weight)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device


def export_inference(module: torch.nn.Module, example_args: Tuple, path: str) -> str:
    """Freeze `module` in eval mode at the example inputs' shapes, dtypes and
    device (`torch.export.export`, no gradient) and save it to `path`.
    Returns path."""
    module.eval()
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_program(path: str) -> torch.export.ExportedProgram:
    """A saved `.pt2` program, with kernels #1-#3 registered first (each
    built on the card at its first launch). Its `example_inputs` are the
    arguments it was exported at, on the device they were saved from."""
    from ..entry import _no_tf32
    from ..ops import bev_pool  # noqa: F401  (registers torch.ops.veon.*)

    # fp32 stays fp32: a process flag does not travel in an artifact
    _no_tf32(torch.device("cuda"))
    return torch.export.load(path)


def load_inference(path: str):
    """A saved `.pt2` program as a callable of the exported module's
    arguments (`load_program`)."""
    return load_program(path).module()


def device_copies(program: torch.export.ExportedProgram) -> dict:
    """The nodes of a program that move data between the host and the
    device: "to_host", a copy to the CPU of a value that lies elsewhere,
    and "scalar_reads", a tensor read as a Python number (each waits for
    the device); "uploads", a host value copied to another device (the
    constants the trace froze, such as the vocabulary merge's indices)."""
    out = {"to_host": [], "scalar_reads": [], "uploads": []}
    for n in program.graph.nodes:
        if n.op != "call_function":
            continue
        if "_local_scalar_dense" in str(n.target) or str(n.target).startswith("aten.item"):
            out["scalar_reads"].append(n.name)
            continue
        src = n.args[0].meta.get("val") if n.args and isinstance(n.args[0], torch.fx.Node) \
            else None
        dst = n.meta.get("val")
        if not (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)) \
                or src.device == dst.device:
            continue
        out["to_host" if dst.device.type == "cpu" else "uploads"].append(n.name)
    return out


def _serving_cfg(preset: str, num_temporal: int = 1, compute_dtype: Optional[str] = None):
    """The preset with its frame count and dtype, and LoRA folded
    (`use_lora=False`), as JAX's exporters build it."""
    from ..configs import presets

    cfg = getattr(presets, preset)(num_temporal=num_temporal)
    return dataclasses.replace(cfg, compute_dtype=compute_dtype or cfg.compute_dtype,
                               depth=dataclasses.replace(cfg.depth, use_lora=False))


def export_flagship(path: str = "work_dir/veon_infer.pt2", preset: str = "veon_b",
                    device="cuda") -> str:
    """Export the F=1 serving forward of `preset` as the flagship's
    (`entry.entry()`: bf16, presorted lift), `entry.ServingForward`: (imgs,
    depth_imgs, metas, ov_weight) -> class grid. JAX's exports veon_b
    whatever the preset; this one exports the preset it is given."""
    from .bench_model import build_serving_forward

    return export_inference(*build_serving_forward(preset, "bfloat16", device=device), path)


def export_streaming(path: str, preset: str = "veon_b", num_temporal: int = 2,
                     raw_uint8: bool = False, device="cuda",
                     variables: Optional[Mapping] = None) -> Tuple[str, Any]:
    """Export the streaming serving step (num_temporal >= 2) in the preset's
    dtype: `serve/streaming.py` `StreamingStep`, (imgs, depth_imgs, metas,
    ov_weight, prev_vox, prev_l2g, text_embed) -> {pred, retrieval,
    early_vox, ...}. A consumer keeps the cache itself, rolling early_vox
    into prev_vox[:, 0]. Returns (path, example_args)."""
    step, example = _build_streaming(preset, num_temporal, raw_uint8=raw_uint8, device=device,
                                     variables=variables)
    return export_inference(step, example, path), example


def _build_streaming(preset: str, num_temporal: int, compute_dtype: Optional[str] = None,
                     raw_uint8: bool = False, device="cuda",
                     variables: Optional[Mapping] = None):
    """(step, example_args) of the streaming serving step, shared by the
    exporter and the streaming benchmark (`cli/main.py`). The weights from
    `variables` (a JAX variables tree) or seeded; the open-vocabulary matrix
    N(0, 1) from numpy's default_rng(0); the example frame and rig from
    `cli/shapes.py` `example_batch_full`, its presorted lift precomputed
    once (the rig is fixed); the cache and the text embedding zero.
    raw_uint8: the step takes raw uint8 HWC frames (from default_rng(1))
    and normalizes them in the graph."""
    from ..cli.shapes import example_batch_full
    from ..entry import _ov_weight, _with_presort, build_model
    from ..serve.streaming import TemporalSession

    dev = resolve_device(device)
    cfg = _serving_cfg(preset, num_temporal, compute_dtype)
    model = build_model(cfg, dev, 0, variables)
    imgs, depth_imgs, metas = example_batch_full(cfg, device=dev)
    ovw, membership = _ov_weight(cfg, dev, seed=0)
    rig = {k: metas[k][:, :1] for k in ("sensor2egos", "ego2globals", "intrins", "post_rots",
                                         "post_trans")}
    rig["bda"] = metas["bda"]
    norm = ("clipsan", cfg.data.depth_norm_method) if raw_uint8 else None
    sess = TemporalSession(model, ovw, membership, rig_metas=_with_presort(model, rig),
                           normalize=norm)
    # JAX's key order: a program takes its dict inputs in the exported order
    m1 = dict(rig, lidarego2global=metas["lidarego2global"],
              lift_sorted=sess.rig_metas["lift_sorted"])
    if raw_uint8:  # the artifact's input signature is uint8
        rng = np.random.default_rng(1)
        imgs, depth_imgs = (torch.from_numpy(rng.integers(0, 256, size=x.shape, dtype=np.uint8))
                            .to(dev) for x in (imgs, depth_imgs))
    imgs, depth_imgs = imgs[:, :1], depth_imgs[:, :1]
    prev_vox, prev_l2g = sess.state()
    return sess.step, (imgs, depth_imgs, m1, ovw, prev_vox, prev_l2g, sess._zero_embed)
