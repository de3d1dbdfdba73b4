"""What every cell of the benchmark shares: the manifest and the files it
names, seeds, the model configuration, the seeded weights, the fixed rig
and drive, the per-layer readers, the judgement against the limits and
the check that no JAX module was loaded.

The benchmark measures the PyTorch port (`veon_tpu_torch`) only. Whatever
belongs to one configuration, traffic mix or per-layer metric lives in a
file of its own that this module finds by the name `BENCHMARK.json`
gives: `configs/<config>.json`, `traffic/<mix>.json` (whose "driver" names
`drivers/<driver>.py`), `metrics/<metric>.py` and `limits/<cell>.json`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import typing
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core peak and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# modules that may not be loaded in a measured process, by top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "veon_tpu")


def set_cache_dirs() -> None:
    """Keep every kernel and compile cache at a fixed path inside the
    checkout, so only a checkout's first run builds (the port's own nvcc
    and g++ builds already go to `build/veon_tpu_torch`)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)


def manifest() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with the files its names lead to."""
    name: str
    config: Dict
    traffic: Dict
    chips: int
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def find_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """The workload `name` of the manifest, its configuration, traffic mix,
    limits and the metrics it reports."""
    bench = bench or manifest()
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    limits_path = BENCH / "limits" / f"{name}.json"
    return Cell(name, load_json(ROOT / conf["file"]),
                load_json(BENCH / "traffic" / f"{w['traffic']}.json"), w["chips"],
                load_json(limits_path)["limits"] if limits_path.exists() else {},
                [m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
                [m for m in bench["per_layer"] if name in m.get("workloads", [name])])


def load_module(path: Path, name: str):
    """Import a file of the benchmark by path (drivers and metric readers)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: Dict):
    return load_module(BENCH / "drivers" / f"{traffic['driver']}.py",
                       f"perfbench_driver_{traffic['driver']}")


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (`tag`) of a run's seed; any whole
    number works, negative or past 64 bits."""
    key = [int(b) for b in tag.encode()]
    words = [int(w) for w in np.frombuffer(
        (int(seed) % (1 << 128)).to_bytes(16, "little"), dtype=np.uint32)]
    return int(np.random.SeedSequence(words + key).generate_state(2, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(subseed(seed, tag))


def _as_lists(x):
    if isinstance(x, (list, tuple)):
        return [_as_lists(v) for v in x]
    if isinstance(x, dict):
        return {k: _as_lists(v) for k, v in x.items()}
    return x


def config_from_file(base, conf: Dict, num_temporal: int = 1,
                     compute_dtype: Optional[str] = None):
    """The configuration of `conf` (a `configs/<name>.json`) as the tree of
    `base` (the reference's or the port's `configs/base.py`): its `sizes`,
    `num_temporal`, and the file's `compute_dtype` unless `compute_dtype`
    is given. The file gives every field; lists become tuples and whole
    numbers floats where the field says so, so the frozen tree compares
    and hashes as one built in code. A key missing or unknown, or a value
    of the wrong kind or length, is refused by its name."""
    sizes = conf["sizes"]
    clash = sorted({"num_temporal", "compute_dtype"} & set(sizes))
    if clash:
        raise ValueError(f"{conf['name']}.json: sizes may not hold {clash}")
    values = dict(sizes, num_temporal=num_temporal,
                  compute_dtype=compute_dtype or conf["compute_dtype"])
    return _typed(base.VeonConfig, values, conf["name"] + ".json", "")


def _typed(hint, value, file: str, key: str):
    """`value` of the file's `key` (a dotted path, "" for `sizes`) as the
    field type `hint`."""
    def refuse(what):
        raise ValueError(f"{file}: {key or 'sizes'} {what}")

    def at(name):
        return f"{key}.{name}" if key else name

    if dataclasses.is_dataclass(hint):
        if not isinstance(value, dict):
            refuse(f"is not an object: {value!r}")
        names = [f.name for f in dataclasses.fields(hint)]
        missing = [at(n) for n in names if n not in value]
        unknown = [at(n) for n in sorted(set(value) - set(names))]
        if missing or unknown:
            refuse(", ".join([f"misses keys {missing}"] * bool(missing)
                             + [f"has unknown keys {unknown}"] * bool(unknown)))
        hints = typing.get_type_hints(hint)
        return hint(**{n: _typed(hints[n], value[n], file, at(n)) for n in names})
    if typing.get_origin(hint) is tuple:
        args = typing.get_args(hint)
        if not isinstance(value, list):
            refuse(f"is not a list: {value!r}")
        if len(args) == 2 and args[1] is Ellipsis:
            args = (args[0],) * len(value)
        if len(args) != len(value):
            refuse(f"has {len(value)} entries, not {len(args)}")
        return tuple(_typed(h, v, file, f"{key}[{i}]")
                     for i, (h, v) in enumerate(zip(args, value)))
    if hint is float and type(value) is int:
        return float(value)
    if type(value) is not hint:
        refuse(f"is not of type {hint.__name__}: {value!r}")
    return value


def build_config(presets, conf: Dict, num_temporal: int = 1, compute_dtype: Optional[str] = None):
    """The port's configuration of `conf` (a `configs/<name>.json`) built
    from the port's `presets` module by the file's `preset`, refused
    unless it holds exactly the file's `sizes`: the file is the
    configuration as it is run."""
    cfg = dataclasses.replace(getattr(presets, conf["preset"])(num_temporal=num_temporal),
                              compute_dtype=compute_dtype or conf["compute_dtype"])
    got = _as_lists(dataclasses.asdict(cfg))
    got.pop("num_temporal")
    got.pop("compute_dtype")
    want = conf["sizes"]
    if got != want:
        diff = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise ValueError(f"preset {conf['preset']} differs from {conf['name']}.json in {diff}")
    return cfg


# ---------------------------------------------------------------- weights --

_NORMAL_002 = {"class_embedding", "positional_embedding", "proj_kernel", "pos_embed",
               "query_embed", "query_pos_embed", "text_projection",
               "relative_position_bias_table"}


def make_weights(cfg, seed: int, device):
    """The benchmark's weights for `cfg`: the reference model
    (`reference/model/veon.py`) built on `device`, its kernels drawn from
    one normal draw of a `torch.Generator` seeded from `seed` on that
    device (fan-in-scaled kernels, N(0, 1/features) embeddings, N(0, 0.02)
    position tables, zero biases, unit norms, as the port's seeded init
    scales them). Returns the reference model; its `state_dict()` is what
    both sides load. One seed gives the same weights on one device type."""
    import torch
    from .reference.model.veon import VeonModel
    from .reference.nn.layers import Conv2d, Conv3d, ConvTranspose2d, Dense, Embed

    torch.use_deterministic_algorithms(True)  # torch.empty fills with NaN: no stale memory
    try:
        model = VeonModel(cfg, device=device)
    finally:
        torch.use_deterministic_algorithms(False)
    plan = []  # (tensor, scale) filled from the normal draw
    seen = set()
    for m in model.modules():
        w = getattr(m, "weight", None)
        if isinstance(m, Embed):
            plan.append((w, 1.0 / math.sqrt(w.shape[1])))
        elif isinstance(m, ConvTranspose2d):
            plan.append((w, 1.0 / math.sqrt(w.shape[0])))
        elif isinstance(m, (Dense, Conv2d, Conv3d)):
            plan.append((w, 1.0 / math.sqrt(w[0].numel())))
        else:
            continue
        seen.add(id(w))
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in seen:
            continue
        if leaf in _NORMAL_002:
            plan.append((p, 0.02))
        elif leaf == "cls_token":
            plan.append((p, 1e-6))
        elif leaf in ("lora_A", "lora_B"):
            raise ValueError("serving towers carry no LoRA adapters")
    total = sum(t.numel() for t, _ in plan)
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    with torch.no_grad():
        draw = torch.randn(total, generator=gen, device=device)
        at = 0
        for t, scale in plan:
            n = t.numel()
            t.copy_(draw[at:at + n].view_as(t) * scale)
            at += n
        del draw
        bad = [n for n, t in model.state_dict().items()
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad:
        raise ValueError(f"weights left unset: {bad[:5]}")
    return model


# ------------------------------------------------------------ rig, drive --

# cam->ego axis permutation for a camera looking along ego +x
_CAM_TO_EGO_BASE = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], np.float32)


def camera_ring(N: int, radius: float = 0.5, height: float = 1.5) -> np.ndarray:
    """(N, 4, 4) cam->ego: camera i yawed 2*pi*i/N around ego z, horizontal
    optical axes (a nuScenes-like surround ring)."""
    out = np.tile(np.eye(4, dtype=np.float32), (N, 1, 1))
    for i in range(N):
        th = 2.0 * np.pi * i / N
        c, s = np.cos(th), np.sin(th)
        rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
        out[i, :3, :3] = rz @ _CAM_TO_EGO_BASE
        out[i, :3, 3] = (radius * c, radius * s, height)
    return out


def rig_metas(cfg) -> Dict[str, np.ndarray]:
    """The fixed six-camera rig of one frame (B=1, F=1): sensor2egos,
    ego2globals (identity), nuScenes-like intrinsics at input scale
    (fx = fy = 0.79 W, principal point (W/2, 0.34 H)), no image
    augmentation, no BEV augmentation."""
    N = cfg.data.num_cams
    H, W = cfg.data.input_size
    K = np.tile(np.eye(3, dtype=np.float32), (1, 1, N, 1, 1))
    K[..., 0, 0] = K[..., 1, 1] = 0.79 * W
    K[..., 0, 2] = W / 2.0
    K[..., 1, 2] = 0.34 * H
    return {"sensor2egos": camera_ring(N)[None, None].copy(),
            "ego2globals": np.tile(np.eye(4, dtype=np.float32), (1, 1, N, 1, 1)),
            "intrins": K, "post_rots": np.tile(np.eye(3, dtype=np.float32), (1, 1, N, 1, 1)),
            "post_trans": np.zeros((1, 1, N, 3), np.float32),
            "bda": np.eye(3, dtype=np.float32)[None]}


def drive_poses(frames: int, gen: np.random.Generator, step_m=(2.0, 5.0),
                yaw_deg=(-4.0, 4.0)) -> np.ndarray:
    """(frames, 4, 4) fp32 lidarego2global poses of a drive: a start at
    nuScenes-like map coordinates (600-1800 m), then `step_m` forward and
    a `yaw_deg` change between keyframes (2 Hz at urban speed)."""
    pos = np.array([gen.uniform(600.0, 1800.0), gen.uniform(600.0, 1800.0), 0.0])
    yaw = gen.uniform(-np.pi, np.pi)
    out = np.tile(np.eye(4), (frames, 1, 1))
    for f in range(frames):
        if f:
            yaw += np.deg2rad(gen.uniform(*yaw_deg))
            pos = pos + gen.uniform(*step_m) * np.array([np.cos(yaw), np.sin(yaw), 0.0])
        c, s = np.cos(yaw), np.sin(yaw)
        out[f, :3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        out[f, :3, 3] = pos
    return out.astype(np.float32)


def depth_tower_hw(cfg):
    """(h, w) of the depth tower's input: the DA-V2 lower-bound resize to
    a multiple of 14, or the zoe branch's depth_input_size as it is."""
    d = cfg.data
    if d.depth_norm_method != "depthanythingv2":
        return tuple(d.depth_input_size)
    h, w = d.depth_input_size
    scale = max(d.dav2_target / h, d.dav2_target / w)

    def constrain(x: float) -> int:
        y = int(np.round(x / 14) * 14)
        return y if y >= d.dav2_target else int(np.ceil(x / 14) * 14)

    return constrain(scale * h), constrain(scale * w)


# ----------------------------------------------------------- the result --

def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def device_info(torch, count: int, peak_bytes: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def read_metrics(cell: Cell, records: Dict) -> Dict[str, Dict]:
    """Each per-layer metric of the cell from its reader
    (`metrics/<name>.py` `read(records)`); a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                             "perfbench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(records)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when the cell has limits and every number they name is
    finite and within its limit; a number without a limit is a reading
    and decides nothing."""
    return bool(limits) and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
        for k, lim in limits.items())


def checks_text(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {numbers.get(k, float('nan'))!r} limit {lim}" for k, lim in sorted(limits.items())]
