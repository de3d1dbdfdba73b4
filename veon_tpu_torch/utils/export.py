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
exported with (`torch.export` flattens dicts in order). Kernels #1-#3 and the deformable
stencil stay in the graph as the registered operators of `ops/bev_pool.py` and
`ops/deform_stencil.py` (`torch.ops.veon.*`), so a
`.pt2` loads only where `veon_tpu_torch` imports; `load_inference` imports
them. A program runs on the device it was exported on.

    export_flagship("work_dir/veon_infer.pt2")          # veon_b F=1, bf16
    export_streaming("work_dir/veon_infer_t2.pt2", "veon_b", 2, raw_uint8=True)
    program = load_inference("work_dir/veon_infer.pt2")
    grid = program(imgs, depth_imgs, metas, ov_weight)

The native bundles (counterparts of JAX's `export_native_bundle` and its
flagship, tiny and streaming exporters) serve with no Python in the loop:
the program compiled by AOTInductor into `model.pt2` (weights inside, as
one blob file beside the compiled code), one `bind/<leaf>.npy` per fixed
input leaf (bf16 as '<V2') and a `manifest.json` with JAX's keys. Its
consumers are the C++ runner and daemon over libtorch
(`csrc/host/aoti_runner.cpp`, `csrc/host/serve_host.cpp`, built by
`ops/native.py` `build_host`), which load the op library `veon_ops`
(kernels #1-#3 and the deformable stencil as C++-registered
`torch.ops.veon.*`) before the package.
JAX's PJRT compile options (`compile_options.pb`, `--copt`) have no
counterpart: the package is compiled at export, for the device it was
exported on.

    export_flagship_native("work_dir/veon_native")      # veon_b F=1, bf16
    veon_serve_host /tmp/veon.sock libveon_ops-<hash>.so model.pt2 \
        --order imgs,depth_imgs,... --bind metas.bda=bind/metas.bda.npy ... --out pred
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import resolve_device


def export_program(module: torch.nn.Module, example_args: Tuple) -> torch.export.ExportedProgram:
    """`module` frozen in eval mode at the example inputs' shapes, dtypes and
    device (`torch.export.export`, no gradient)."""
    module.eval()
    with torch.no_grad():
        return torch.export.export(module, tuple(example_args))


def export_inference(module: torch.nn.Module, example_args: Tuple, path: str) -> str:
    """`export_program` saved to `path`. Returns path."""
    program = export_program(module, example_args)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_program(path: str) -> torch.export.ExportedProgram:
    """A saved `.pt2` program, with kernels #1-#3 and the deformable
    stencil registered first (each built on the card at its first launch).
    Its `example_inputs` are the arguments it was exported at, on the device
    they were saved from."""
    from ..entry import _no_tf32
    from ..ops import bev_pool, deform_stencil  # noqa: F401  (register torch.ops.veon.*)

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


# ---------------------------------------------------------- native bundles --

# AOTInductor's options for a bundle: the weights as one blob file in the
# package, never in the compiled library (VEON-B's ~2 GB of bf16 constants
# would overflow its relocations).
AOTI_CONFIGS = {"aot_inductor.package_constants_in_so": False,
                "aot_inductor.package_constants_on_disk_format": "binary_blob"}


@functools.lru_cache(maxsize=None)
def _openmp_cxx() -> str:
    """The first C++ compiler, of $CXX and g++ and c++ on the PATH, that
    links an OpenMP program: AOTInductor builds its wrapper with -fopenmp,
    and a $CXX without libgomp fails there."""
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "omp.cpp")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        for cxx in dict.fromkeys(filter(None, (os.environ.get("CXX"), shutil.which("g++"),
                                               shutil.which("c++")))):
            r = subprocess.run([cxx, "-fopenmp", src, "-o", os.path.join(d, "a.out")],
                               capture_output=True)
            if r.returncode == 0:
                return cxx
    raise RuntimeError("no C++ compiler here links -fopenmp, which AOTInductor needs")


def _aoti_configs(weights: bool) -> dict:
    """The C++ compiler (`_openmp_cxx`), and for a program with weights
    `AOTI_CONFIGS` (a program without any would leave an empty blob, which
    the loader cannot map)."""
    out = {"cpp.cxx": (None, _openmp_cxx())}
    if weights:
        out.update(AOTI_CONFIGS)
    return out


def _write_npy(path: str, t: torch.Tensor) -> None:
    """np.save of a tensor, plus the one dtype numpy cannot spell: bfloat16
    is written with descr '<V2' (raw 2-byte void), as JAX's `_write_npy`,
    which the C++ reader (`csrc/host/frame.h` parse_npy) maps back to
    bf16."""
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        np.save(path, t.numpy())
        return
    raw = t.view(torch.int16).numpy()
    shape = "(" + ",".join(str(d) for d in raw.shape) + ("," if raw.ndim == 1 else "") + ")"
    hdr = "{'descr': '<V2', 'fortran_order': False, 'shape': " + shape + ", }"
    total = 10 + len(hdr) + 1
    hdr += " " * (((total + 63) // 64) * 64 - total) + "\n"
    with open(path, "wb") as f:
        f.write(b"\x93NUMPY\x01\x00")
        f.write(len(hdr).to_bytes(2, "little"))
        f.write(hdr.encode())
        f.write(raw.tobytes())


def read_npy(path: str) -> torch.Tensor:
    """A bundle's .npy file as a tensor, '<V2' as bfloat16."""
    arr = np.load(path)
    if arr.dtype.str == "|V2":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_name(top: str, path) -> str:
    """JAX's leaf names: the top-level argument name plus the key path,
    separators as '.' (['a']['b'] -> a.b)."""
    s = top + pytree.keystr(path)
    s = "".join(c if (c.isalnum() or c in "._") else "." for c in s)
    return re.sub(r"\.+", ".", s).strip(".")


def _aval(t) -> str:
    """A tensor's dtype and shape as JAX prints an aval: float32[1,6,3]."""
    return f"{str(t.dtype).replace('torch.', '')}[{','.join(str(d) for d in t.shape)}]"


def export_native_bundle(module: torch.nn.Module, example_args: Tuple, outdir: str,
                         arg_names: Tuple[str, ...], request_args: Tuple[str, ...] = (),
                         out_names: Tuple[str, ...] = ()) -> str:
    """Everything the C++ consumers need to serve `module` at the example
    inputs with no Python in the loop:

      <outdir>/model.pt2       the program compiled by AOTInductor for the
                               inputs' device (`AOTI_CONFIGS`); its extern
                               nodes call kernels #1-#3 and the
                               deformable stencil by op name
      <outdir>/bind/<leaf>.npy one file per fixed input leaf, for --bind
      <outdir>/manifest.json   JAX's keys: "order" (the package's flat input
                               names), "request", "binds", "outputs",
                               "in_shapes", "out_shapes", "serve_cmd"; and
                               "device" and the export and compile seconds

    `arg_names` names each top-level argument (a leaf is named by it and its
    key path, `_leaf_name`); the leaves under a name in `request_args` come
    with each request, every other leaf is bound from disk. Without
    `out_names` the outputs are named by their dict keys (`_output_names`).
    The package takes its leaves in `torch.utils._pytree` order, which keeps a dict's
    insertion order where JAX sorts its keys: only the name sets match
    JAX's. Returns outdir."""
    if len(arg_names) != len(example_args):
        raise ValueError(f"{len(arg_names)} names for {len(example_args)} arguments")
    # the consumers pass contiguous tensors, and the package checks its
    # example inputs' strides, a size-1 dim's too (a frame sliced off a
    # batch keeps the batch's stride there, which `contiguous()` leaves)
    example_args = pytree.tree_map(
        lambda t: t.clone(memory_format=torch.contiguous_format)
        if isinstance(t, torch.Tensor) else t, tuple(example_args))
    t0 = time.perf_counter()
    program = export_program(module, example_args)
    export_s = time.perf_counter() - t0
    os.makedirs(os.path.join(outdir, "bind"), exist_ok=True)
    t0 = time.perf_counter()
    torch._inductor.aoti_compile_and_package(
        program, package_path=os.path.join(outdir, "model.pt2"),
        inductor_configs=_aoti_configs(bool(program.state_dict or program.constants)))
    compile_s = time.perf_counter() - t0

    order, request, binds, in_shapes = [], [], {}, []
    for top, arg in zip(arg_names, example_args):
        for path, leaf in pytree.tree_flatten_with_path(arg)[0]:
            name = _leaf_name(top, path)
            if "," in name or name in order:
                raise ValueError(f"leaf name {name!r} is not unique or holds a comma")
            order.append(name)
            in_shapes.append(_aval(leaf))
            if top in request_args:
                request.append(name)
            else:
                _write_npy(os.path.join(outdir, "bind", name + ".npy"), leaf)
                binds[name] = f"bind/{name}.npy"
    n_in = len(program.graph_signature.user_inputs)
    if len(order) != n_in:
        raise ValueError(f"{len(order)} leaves for a program of {n_in} inputs")
    out_nodes = {n.name: n for n in program.graph.nodes if n.op != "output"}
    outs = [out_nodes[name].meta["val"] for name in program.graph_signature.user_outputs]
    outputs = list(out_names) or _output_names(program, len(outs))
    if len(outputs) != len(outs):
        raise ValueError(f"{len(outputs)} output names for {len(outs)} outputs")
    serve_cmd = ("veon_serve_host <socket> libveon_ops.so model.pt2 --order " + ",".join(order)
                 + " " + " ".join(f"--bind {n}={p}" for n, p in binds.items())
                 + " --out " + ",".join(outputs))
    device = next(iter(t.device for t in pytree.tree_leaves(example_args)
                       if isinstance(t, torch.Tensor))).type
    with open(os.path.join(outdir, "manifest.json"), "w") as f:
        json.dump({"order": order, "request": request, "binds": binds, "outputs": outputs,
                   "in_shapes": in_shapes, "out_shapes": [_aval(t) for t in outs],
                   "serve_cmd": serve_cmd, "device": device,
                   "export_s": export_s, "compile_s": compile_s}, f, indent=1)
    return outdir


def _output_names(program: torch.export.ExportedProgram, n: int) -> list:
    """Names of a program's n flat outputs: their key paths (JAX's sanitizer)
    where every output sits under a dict key, else out0..out{n-1}."""
    paths = [p for p, _ in pytree.tree_flatten_with_path(
        pytree.tree_unflatten([0] * n, program.call_spec.out_spec))[0]]
    if all(any(isinstance(k, pytree.MappingKey) for k in p) for p in paths):
        return [_leaf_name("", p) for p in paths]
    return [f"out{i}" for i in range(n)]


class SplitPred(torch.nn.Module):
    """`inner`'s (B, X, Y, Z) class grid as `parts` chunks along X (JAX's
    `_split_pred_fn`): the consumer concatenates them on axis 1, as the
    manifest's "split_concat" says."""

    def __init__(self, inner: torch.nn.Module, parts: int):
        super().__init__()
        self.inner, self.parts = inner, parts

    def forward(self, *args):
        pred = self.inner(*args)
        if pred.shape[1] % self.parts:
            raise ValueError(f"X={pred.shape[1]} does not split into {self.parts} parts")
        return tuple(torch.split(pred, pred.shape[1] // self.parts, dim=1))


def _annotate_split(outdir: str, k: int) -> None:
    mpath = os.path.join(outdir, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["split_concat"] = {"axis": 1, "parts": k, "name": "pred"}
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)


def _export_f1_native(forward, args, outdir: str, split_output: int) -> str:
    """An F=1 serving bundle: imgs and depth_imgs per request, the metas and
    the open-vocabulary matrix bound, one `pred` (or split_output chunks)."""
    names = ("imgs", "depth_imgs", "metas", "ovw")
    if split_output <= 1:
        return export_native_bundle(forward, args, outdir, names, ("imgs", "depth_imgs"),
                                    ("pred",))
    export_native_bundle(SplitPred(forward, split_output), args, outdir, names,
                         ("imgs", "depth_imgs"),
                         tuple(f"pred.{i}" for i in range(split_output)))
    _annotate_split(outdir, split_output)
    return outdir


def export_flagship_native(outdir: str, split_output: int = 1, device="cuda",
                           variables: Optional[Mapping] = None) -> str:
    """Native bundle of the flagship F=1 serving forward (VEON-B, bf16, the
    fixed rig's presorted lift: kernel #1): `bench_model.py`
    `build_serving_forward`, the rig metas (with "lift_sorted") and the
    open-vocabulary matrix bound, imgs and depth_imgs per request, one
    `pred`. split_output > 1 returns the class grid as K chunks along X
    (pred.0..pred.K-1, "split_concat" in the manifest)."""
    from .bench_model import build_serving_forward

    forward, args = build_serving_forward("veon_b", "bfloat16", device=device,
                                          variables=variables)
    return _export_f1_native(forward, args, outdir, split_output)


def export_tiny_native(outdir: str, split_output: int = 1, device="cuda",
                       variables: Optional[Mapping] = None) -> str:
    """`veon_tiny_test` native bundle, the daemon's smoke: the flagship's
    request, bind and output contract at the tiny size, fp32, on JAX's
    tiny inputs (`cli/shapes.py` `example_batch`, depth_imgs zero at the
    frames' shape, the open-vocabulary matrix from default_rng(0), the rig
    without a presort, so the lift sorts in the graph: kernel #2 or #3)."""
    from ..entry import ServingForward, _ov_weight, build_model
    from ..cli.shapes import example_batch

    dev = resolve_device(device)
    cfg = _serving_cfg("veon_tiny_test")
    model = build_model(cfg, dev, 0, variables)
    imgs, _depth, metas = example_batch(cfg, B=1, device=dev)
    ovw, membership = _ov_weight(cfg, dev, seed=0)
    args = (imgs, torch.zeros_like(imgs), metas, ovw)
    return _export_f1_native(ServingForward(model, membership), args, outdir, split_output)


class StreamingNative(torch.nn.Module):
    """The streaming step with the frame's ego pose split out of the rig
    (it changes every frame; bound from disk it would freeze the car)."""

    def __init__(self, step: torch.nn.Module):
        super().__init__()
        self.step = step

    def forward(self, imgs, depth_imgs, rig, lidarego2global, ovw, prev_vox, prev_l2g,
                text_embed):
        return self.step(imgs, depth_imgs, dict(rig, lidarego2global=lidarego2global), ovw,
                         prev_vox, prev_l2g, text_embed)


def export_streaming_native(outdir: str, preset: str = "veon_b", num_temporal: int = 2,
                            raw_uint8: bool = False, device="cuda",
                            variables: Optional[Mapping] = None) -> str:
    """Native bundle of the streaming step (`_build_streaming`, the
    preset's dtype): the rig metas with the presorted lift and the
    open-vocabulary matrix bound; per request the frame, its
    `lidarego2global`, the cache (prev_vox, prev_l2g) and text_embed. The
    response carries the step's outputs in the manifest's order, early_vox
    among them: the client rolls it into the next request's prev_vox
    (newest first) and this frame's pose into prev_l2g, as
    `TemporalSession.infer` does."""
    step, example = _build_streaming(preset, num_temporal, raw_uint8=raw_uint8, device=device,
                                     variables=variables)
    imgs, depth_imgs, m1, ovw, prev_vox, prev_l2g, te = example
    rig = {k: v for k, v in m1.items() if k != "lidarego2global"}
    module = StreamingNative(step)
    args = (imgs, depth_imgs, rig, m1["lidarego2global"], ovw, prev_vox, prev_l2g, te)
    names = ("imgs", "depth_imgs", "rig", "lidarego2global", "ovw", "prev_vox", "prev_l2g",
             "text_embed")
    return export_native_bundle(module, args, outdir, names,
                                ("imgs", "depth_imgs", "lidarego2global", "prev_vox", "prev_l2g",
                                 "text_embed"))


class NativeBundle:
    """A bundle as its consumers see it: the manifest, the bound leaves,
    the flat inputs of a request, and the argv of the C++ daemon and
    runner (built by `ops/native.py` `build_host`)."""

    def __init__(self, outdir: str):
        self.dir = os.path.abspath(outdir)
        with open(os.path.join(self.dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.package = os.path.join(self.dir, "model.pt2")

    def binds(self) -> Dict[str, torch.Tensor]:
        return {n: read_npy(os.path.join(self.dir, p)) for n, p in self.manifest["binds"].items()}

    def flat_inputs(self, request: Mapping[str, torch.Tensor], device) -> list:
        """The package's flat inputs: the bound leaves and the request's, in
        the manifest's order, on `device`."""
        bound = self.binds()
        return [(bound[n] if n in bound else torch.as_tensor(request[n])).to(device)
                for n in self.manifest["order"]]

    def daemon_argv(self, socket: str, once: bool = False) -> list:
        from ..ops import native

        m = self.manifest
        argv = [str(native.host_path("veon_serve_host")), socket,
                str(native.host_path("veon_ops")), self.package, "--order", ",".join(m["order"])]
        for n, p in m["binds"].items():
            argv += ["--bind", f"{n}={os.path.join(self.dir, p)}"]
        return argv + ["--out", ",".join(m["outputs"])] + (["--once"] if once else [])

    def runner_argv(self, input_paths: Sequence[str], out_prefix: str) -> list:
        from ..ops import native

        return [str(native.host_path("veon_aoti_runner")), str(native.host_path("veon_ops")),
                self.package, *input_paths, "--out", out_prefix]

    def load_python(self):
        """The package loaded in this process (`torch._inductor.aoti_load_package`),
        its extern nodes calling the Python ops of `ops/bev_pool.py` and
        `ops/deform_stencil.py`: run(flat inputs) -> {output name: tensor}."""
        from ..ops import bev_pool, deform_stencil  # noqa: F401  (register torch.ops.veon.*)

        loader = torch._inductor.aoti_load_package(self.package).loader
        names = self.manifest["outputs"]
        return lambda flat: dict(zip(names, loader.boxed_run(list(flat))))

    def concat_split(self, resp: Mapping[str, Any]) -> Dict[str, Any]:
        """A response with a split grid's chunks joined back ("split_concat")."""
        sc = self.manifest.get("split_concat")
        if not sc:
            return dict(resp)
        parts = [resp[f"{sc['name']}.{i}"] for i in range(sc["parts"])]
        cat = torch.cat if isinstance(parts[0], torch.Tensor) else np.concatenate
        out = {k: v for k, v in resp.items() if not k.startswith(sc["name"] + ".")}
        out[sc["name"]] = cat(parts, sc["axis"])
        return out
