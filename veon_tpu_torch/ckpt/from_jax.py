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
  Embed embedding (rows, features)    -> weight, as is
  BatchNorm batch_stats mean / var    -> running_mean / running_var
  nn.scan stacks (leading layer axis) -> ModuleList index
  other params (LayerScales, cls tokens, BEiT's q/v biases and relative-
  position tables)                    -> the parameter of that name, as is
The port names its modules as the flax tree does, with one numeric path
component where a scan stack is unstacked. Every JAX leaf must be
consumed; with strict=True every port entry must be filled too, while
strict=False converts a partial tree (a grads or optimizer-moment tree of
the trainable params, or the batch_stats alone) into the entries it
covers. A leftover JAX leaf always raises.

`load_families` fills the top-level submodules of a model that a partial
tree holds (the converted families of the reference's checkpoints, loaded
over a seeded model by `cli/main.py` `checkpoint_model`), each strict on
both sides.

`variables_from_model` is the inverse: a model's JAX variables tree as
numpy (or that of some of its entries: an EMA, optimizer moments), which
the eval-time conv-BN folding of `ckpt/convert.py` `fuse_conv_bn` takes
(`cli/main.py` `test --fuse-conv-bn`) and `ckpt/io.py` saves.

`load_text_tower` fills a `CLIPTextEncoder` from the text-tower tree of
`veon_tpu/ckpt/convert.py` `convert_text_tower` (the `extras["text_tower"]`
params, scan-stacked `resblocks/block/...`), strict on both sides.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.layers import BatchNorm, Conv2d, Conv3d, ConvTranspose2d, Dense, Embed, LayerNorm


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
    if leaf == "weight" and isinstance(owner, Embed):
        return "params", "embedding"
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


def _from_torch_layout(owner: nn.Module, leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf != "weight":
        return a
    if isinstance(owner, Dense):
        return a.T
    if isinstance(owner, Conv2d):
        return a.transpose(2, 3, 1, 0)
    if isinstance(owner, Conv3d):
        return a.transpose(2, 3, 4, 1, 0)
    if isinstance(owner, ConvTranspose2d):
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]
    return a


def _stack(entries: Dict[Tuple[int, ...], np.ndarray]) -> np.ndarray:
    """One array from the unstacked scan entries {index path: array}."""
    if () in entries:
        return entries[()]
    heads = sorted({i[0] for i in entries})
    if heads != list(range(len(heads))):
        raise ValueError(f"scan entries {heads} are not 0..n-1")
    return np.stack([_stack({i[1:]: a for i, a in entries.items() if i[0] == h})
                     for h in heads])


def variables_from_model(model: nn.Module, tensors: Mapping[str, torch.Tensor] = None) -> Dict:
    """The JAX variables tree {"params", "batch_stats"} of `model` as nested
    dicts of numpy arrays: the inverse of `state_dict_from_jax`, so
    `load_from_jax(model, variables_from_model(model))` changes nothing.
    With `tensors` ({port name: tensor} for some of the model's entries:
    an EMA, the optimizer moments of the trainable params) the tree of
    those alone, laid out as the model's own entries of those names; the
    inverse is `state_dict_from_jax(model, tree, strict=False)`."""
    groups: Dict[Tuple[str, ...], Dict[Tuple[int, ...], np.ndarray]] = {}
    for name, t in (model.state_dict() if tensors is None else tensors).items():
        parts = name.split(".")
        owner = model.get_submodule(".".join(parts[:-1]))
        col, leaf = _source(owner, parts[-1])
        key = (col,) + tuple(p for p in parts[:-1] if not p.isdigit()) + (leaf,)
        index = tuple(int(p) for p in parts[:-1] if p.isdigit())
        a = _from_torch_layout(owner, parts[-1], t.detach().float().cpu().numpy())
        groups.setdefault(key, {})[index] = np.array(a)  # a copy, 0-d kept
    tree: Dict = {}
    for key, entries in groups.items():
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = _stack(entries)
    return tree


def load_from_jax(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill `model` from JAX `variables` (strict on both sides)."""
    model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
    return model


def load_families(model: nn.Module, variables: Mapping) -> nn.Module:
    """Fill each top-level submodule of `model` ("family": depth,
    clip_visual, ..., alignnet) named in `variables`, strict on both sides
    within the family; families the tree does not name stay as they are.
    A family the model lacks raises."""
    children = dict(model.named_children())
    families = {f for col in variables.values() for f in col}
    unknown = sorted(families - set(children))
    if unknown:
        raise ValueError(f"JAX leaves not consumed by the port: families {unknown}")
    for f in sorted(families):
        load_from_jax(children[f], {col: tree[f] for col, tree in variables.items() if f in tree})
    return model


def load_text_tower(tower: nn.Module, params: Mapping) -> nn.Module:
    """Fill a `CLIPTextEncoder` from the JAX text tower's params tree
    (token_embedding, positional_embedding, resblocks, ln_final,
    text_projection), strict on both sides."""
    return load_from_jax(tower, {"params": params})
