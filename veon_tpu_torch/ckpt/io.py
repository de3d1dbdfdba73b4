"""Training checkpoints, resume and publishing (counterpart of
`veon_tpu/ckpt/io.py`, with `torch.save` in place of orbax).

Layout: `<dir>/step_<n>/state.pt` holds the whole train state as one tree
of tensors, the EMA travelling with it:
  params, batch_stats           the model's flax-named variables tree
                                (`from_jax.variables_from_model`), so
                                `test --ckpt` loads it with
                                `load_from_jax`'s strict rules;
  opt_state                     count, mu and nu (trees of the trainable
                                params), mini_step and, with gradient
                                accumulation, acc_grads;
  ema_params, ema_batch_stats   the EMA shadow, in the same layout;
  step, ema_updates             the counters.
`step_<n>/NEXT_EPOCH`, written after the tree, holds the next epoch to run.
Files load with `torch.load(weights_only=True)`.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..train.step import AdamState, TrainState
from .from_jax import load_from_jax, state_dict_from_jax, variables_from_model

STATE_FILE = "state.pt"


def _tensors(tree):
    """Nested dicts with numpy arrays, numbers or tensors -> tensors on the CPU."""
    if isinstance(tree, Mapping):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return torch.from_numpy(np.array(tree, copy=True))


def state_tree(state: TrainState) -> Dict:
    """The checkpoint tree of a `TrainState` (the layout above)."""
    m, opt = state.model, state.opt_state
    v = variables_from_model(m)
    ema = variables_from_model(m, {**state.ema_params, **state.ema_batch_stats})
    opt_tree = {"count": np.int32(opt.count),
                "mu": variables_from_model(m, opt.mu).get("params", {}),
                "nu": variables_from_model(m, opt.nu).get("params", {}),
                "mini_step": np.int32(opt.mini_step)}
    if opt.acc_grads is not None:
        opt_tree["acc_grads"] = variables_from_model(m, opt.acc_grads).get("params", {})
    return _tensors({"params": v["params"], "batch_stats": v.get("batch_stats", {}),
                     "opt_state": opt_tree, "ema_params": ema["params"],
                     "ema_batch_stats": ema.get("batch_stats", {}),
                     "step": np.int32(state.step), "ema_updates": state.ema_updates})


def save_checkpoint(directory: str, step: int, state: Any,
                    next_epoch: Optional[int] = None) -> str:
    """Save `state` (a `TrainState`, or a tree of arrays) as
    `<directory>/step_<step>`, replacing one that is there; with
    `next_epoch` the exact resume marker is written after the tree, so a
    torn save cannot point past real data. Returns the path."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tree = state_tree(state) if isinstance(state, TrainState) else _tensors(state)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if next_epoch is not None:
        with open(os.path.join(path, "NEXT_EPOCH"), "w") as f:
            f.write(str(int(next_epoch)))
    return path


def checkpoint_next_epoch(path: str) -> Optional[int]:
    """The exact resume epoch `save_checkpoint` recorded, or None for a
    checkpoint without the marker (callers estimate it from the step)."""
    marker = os.path.join(os.path.abspath(path), "NEXT_EPOCH")
    if os.path.isfile(marker):
        with open(marker) as f:
            return int(f.read().strip())
    return None


def load_checkpoint(path: str, target: Optional[TrainState] = None):
    """The checkpoint tree at `path` (tensors on the CPU); with `target`,
    the state restored into it instead: its model's params and running
    stats loaded strictly, and a `TrainState` with the optimizer, EMA and
    counters of the checkpoint on the model's device."""
    tree = torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location="cpu",
                      weights_only=True)
    if target is None:
        return tree
    m = target.model
    dev = next(m.parameters()).device
    load_from_jax(m, {"params": tree["params"], "batch_stats": tree["batch_stats"]})

    def named(col, sub):
        return {n: t.to(dev) for n, t in state_dict_from_jax(m, {col: sub}, strict=False).items()}

    ema = {n: t.to(dev) for n, t in state_dict_from_jax(
        m, {"params": tree["ema_params"], "batch_stats": tree["ema_batch_stats"]}).items()}
    o = tree["opt_state"]
    mu = named("params", o["mu"])
    if sorted(mu) != sorted(target.opt_state.mu):
        raise ValueError(f"{path}: the checkpoint's trainable set differs from the target's")
    acc = named("params", o["acc_grads"]) if "acc_grads" in o else None
    if (acc is None) != (target.opt_state.acc_grads is None):
        raise ValueError(f"{path}: saved with another gradient accumulation than the target's")
    opt = AdamState(int(o["count"]), mu, named("params", o["nu"]), int(o["mini_step"]), acc)
    return TrainState(m, opt, {n: ema[n] for n in target.ema_params},
                      {n: ema[n] for n in target.ema_batch_stats}, int(tree["step"]),
                      tree["ema_updates"].to(dev))


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _keystr(path: Tuple[str, ...]) -> str:
    """`jax.tree_util.keystr` of a path of dict keys: "['params']['w']"."""
    return "".join(f"[{k!r}]" for k in path)


def publish_checkpoint(path: str, out_path: str, ema: bool = False) -> str:
    """A publish-ready checkpoint: the tree stripped to {params,
    batch_stats} (with `ema`, the EMA shadow published as them), saved as
    '<out_path>-<sha8>', sha8 the first 8 hex digits of a SHA-256 over the
    leaves sorted by path: each leaf's keystr path, dtype, shape and raw
    bytes, as the JAX package hashes them, so the same weights get the same
    name. A stripped tree given `ema` raises. Returns the directory."""
    state = load_checkpoint(path)
    if ema and "ema_params" not in state:
        raise ValueError(f"{path} carries no EMA shadow (already published / stripped) - "
                         "publish without ema=True")
    pub = {"params": state["ema_params" if ema else "params"],
           "batch_stats": state["ema_batch_stats" if ema else "batch_stats"]}
    h = hashlib.sha256()
    for keys, leaf in sorted(_leaves(pub), key=lambda kv: _keystr(kv[0])):
        arr = leaf.numpy()
        h.update(_keystr(keys).encode())
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    final = f"{os.path.abspath(out_path).rstrip(os.sep)}-{h.hexdigest()[:8]}"
    os.makedirs(final, exist_ok=True)
    torch.save(pub, os.path.join(final, STATE_FILE))
    return final


def find_latest(directory: str) -> Optional[str]:
    """The highest step_<n> checkpoint under directory (--auto-resume)."""
    steps = list_checkpoints(directory)
    return steps[-1][1] if steps else None


def list_checkpoints(directory: str, min_step: Optional[int] = None,
                     max_step: Optional[int] = None) -> List[Tuple[int, str]]:
    """[(n, path)] of every step_<n> checkpoint under directory, sorted by
    step, bounded by min_step / max_step where given (the epoch sweep)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append((int(name.split("_")[1]), os.path.join(directory, name)))
            except ValueError:
                pass
    return sorted(s for s in steps if (min_step is None or s[0] >= min_step)
                  and (max_step is None or s[0] <= max_step))
