"""JAX variables -> the port's state_dict.

Takes the flax `{"params": ..., "batch_stats": ...}` tree of the JAX model
as nested dicts of numpy arrays and inverts the layout rules of
`veon_tpu/ckpt/convert.py`:
  Dense kernel (in, out)              -> weight (out, in)
  Conv kernel (kh, kw, in, out)       -> weight (out, in, kh, kw)
  Conv3d kernel (kd, kh, kw, in, out) -> weight (out, in, kd, kh, kw)
  ConvTranspose kernel (kh, kw, in, out), applied unflipped by flax
                                      -> weight (in, out, kh, kw), flipped
  LayerNorm / BatchNorm scale         -> weight
  BatchNorm batch_stats mean / var    -> running_mean / running_var
  nn.scan stacks (leading layer axis) -> ModuleList index
The port names its modules as the flax tree does, with one numeric path
component where a scan stack is unstacked. Every JAX leaf must be
consumed; with strict=True every port entry must be filled too, while
strict=False converts a partial tree (a grads or optimizer-moment tree of
the trainable params, or the batch_stats alone) into the entries it
covers. A leftover JAX leaf always raises.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.layers import BatchNorm, Conv2d, Conv3d, ConvTranspose2d, Dense, LayerNorm


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _source(owner: nn.Module, leaf: str) -> Tuple[str, str]:
    """(flax collection, flax leaf name) of the port entry `leaf` of `owner`."""
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", leaf[len("running_"):]
    if leaf == "weight" and isinstance(owner, (LayerNorm, BatchNorm)):
        return "params", "scale"
    if leaf == "weight" and isinstance(owner, (Dense, Conv2d, Conv3d, ConvTranspose2d)):
        return "params", "kernel"
    return "params", leaf


def _to_torch_layout(owner: nn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "weight":
        return a
    if isinstance(owner, Dense):
        return a.T
    if isinstance(owner, Conv2d):
        return a.transpose(3, 2, 0, 1)
    if isinstance(owner, Conv3d):
        return a.transpose(4, 3, 0, 1, 2)
    if isinstance(owner, ConvTranspose2d):
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    return a


def state_dict_from_jax(model: nn.Module, variables: Mapping, strict: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """The port's state_dict for `model` (or the part of it that a partial
    tree covers, strict=False) built from JAX `variables`."""
    leaves = {(col,) + path: a for col in variables
              for path, a in _flatten(variables[col]).items()}
    used: Dict[Tuple[str, ...], set] = {}
    sd, missing = {}, []
    for name, ref in model.state_dict().items():
        parts = name.split(".")
        owner = model.get_submodule(".".join(parts[:-1]))
        index = [int(p) for p in parts[:-1] if p.isdigit()]
        col, leaf = _source(owner, parts[-1])
        key = (col,) + tuple(p for p in parts[:-1] if not p.isdigit()) + (leaf,)
        if key not in leaves:
            missing.append(name)
            continue
        a = leaves[key]
        for i in index:  # unstack the scan axis
            a = a[i]
        a = _to_torch_layout(owner, parts[-1], a)
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: JAX {'/'.join(key)} has shape {a.shape}, "
                             f"port expects {tuple(ref.shape)}")
        used.setdefault(key, set()).add(tuple(index))
        sd[name] = torch.from_numpy(np.array(a, copy=True)).to(ref.dtype)
    if missing and strict:
        raise ValueError(f"port entries with no JAX leaf: {missing}")
    leftover = []
    for key, a in leaves.items():
        idx = used.get(key)
        if idx is None or (idx != {()} and len(idx) != a.shape[0]):
            leftover.append("/".join(key))
    if leftover:
        raise ValueError(f"JAX leaves not consumed by the port: {leftover}")
    return sd


def load_from_jax(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill `model` from JAX `variables` (strict on both sides)."""
    model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
    return model
