"""CUDA graphs of a streaming session's fixed-shape stages.

A region is the body of one stage call, named where the model's code
makes the call:

    out = graphs.region("hsa", self._forward, images, feats)

Outside a session's step (training, the batched forward, the frame
server, an export) it is the plain call `fn(*args)`. Inside the step of a
`serve/streaming.py` `TemporalSession` it is one region of the session's
`StepGraphs`: captured into a CUDA graph once, on the card, at set-up
(`TemporalSession.capture`), then replayed on each request in place of
the Python that issues its ops. The arithmetic, the kernels and their
order are those of the plain call.

A region never holds an instrument: the spans and counters of
`utils/tracing.py`, the module calls that the benchmark hooks from outside
and the methods it wraps all lie between regions, so each fires once a
request on replay as eagerly. A region's inner modules are recorded when
it is captured; one that has gained a forward hook or pre-hook since (or
a global one) runs the region eagerly, so no hook is ever skipped.

Inputs: a tensor that is a capture's output, or a view of one, is read in
place (copied into only where an eager stand-in produced it); a tensor of
the session's own (`StepGraphs.stable`: the rig's presort, the
open-vocabulary matrix) is read in place and must come again; any other
tensor is copied into the region's own buffer before each replay. Other
arguments are part of the region's signature. A region whose signature
(argument structure, constants, tensor shapes, dtypes, devices) differs
from its capture's runs eagerly. Outputs are the capture's buffers, which
the next replay overwrites: a session hands its caller none of them
(`StepGraphs.unshared`). Each replay adds the kernel launches its
capture counted to the ops' `.launches` counters (`tracing.launch_counters`).

Counters: `graph_replays`, one per region replayed, and `graph_eager`,
one per region run eagerly inside a session's step, each added to the
span the region runs in.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.nn.modules import module as _module

from . import tracing

_local = threading.local()  # .graphs: the StepGraphs of the step running on this thread
_TENSOR = object()  # a tensor leaf in a flattened signature
_MISS = object()
# how a region reads an input tensor on replay
_OWN, _ALIAS, _STABLE = "own", "alias", "stable"


def region(name: str, fn: Callable, *args):
    """fn(*args), or the replay of its capture inside a session's step.
    The k-th call of `name` in a step is its own region."""
    gs = None if torch.compiler.is_compiling() else getattr(_local, "graphs", None)
    if gs is None or gs.inside:
        return fn(*args)
    return gs.call(name, fn, args)


def _flatten(x, leaves: List[torch.Tensor]):
    """x's structure with its tensors taken out into `leaves`; dicts, lists
    and tuples are walked, anything else is a constant of the structure."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return _TENSOR
    if type(x) is dict:
        return (dict, tuple(x), tuple(_flatten(v, leaves) for v in x.values()))
    if type(x) in (list, tuple):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    return x


def _unflatten(spec, leaves):
    """The structure `spec` with its tensors taken from the iterator `leaves`."""
    if spec is _TENSOR:
        return next(leaves)
    if type(spec) is not tuple:
        return spec
    if spec[0] is dict:
        return dict(zip(spec[1], (_unflatten(s, leaves) for s in spec[2])))
    return spec[0](_unflatten(s, leaves) for s in spec[1])


def _global_hooks() -> Tuple:
    return (tuple(_module._global_forward_pre_hooks), tuple(_module._global_forward_hooks))


class _Region:
    """One captured region: its graph, signature, input buffers and their
    kinds, output buffers, the hooks of its inner modules at capture and
    the launches its capture counted."""

    __slots__ = ("graph", "spec", "inputs", "kinds", "out_spec", "outputs", "empty", "hooks",
                 "global_hooks", "launches")

    def hooked(self) -> bool:
        """Whether a module the region calls (or every module) has gained
        a forward hook or pre-hook since the capture."""
        return (any(self.empty) or any(tuple(d) != keys for d, keys in self.hooks)
                or _global_hooks() != self.global_hooks)

    def replay(self, args):
        """The region's outputs for `args`, replayed; _MISS where the
        signature differs, a session tensor is another, or a hook was added."""
        leaves: List[torch.Tensor] = []
        if _flatten(args, leaves) != self.spec:
            return _MISS
        copies = []
        for x, s, kind in zip(leaves, self.inputs, self.kinds):
            if x is s:
                continue
            if x.shape != s.shape or x.dtype != s.dtype or x.device != s.device:
                return _MISS
            if x.data_ptr() == s.data_ptr() and x.stride() == s.stride():
                continue
            if kind == _STABLE:
                return _MISS
            copies.append((s, x))
        if self.hooked():
            return _MISS
        for s, x in copies:
            s.copy_(x)
        self.graph.replay()
        for f, n in self.launches:
            f.launches += n
        return _unflatten(self.out_spec, iter(self.outputs))


class StepGraphs:
    """The regions of one session's step, keyed by (name, k-th call of the
    step), in one memory pool shared in the order they were captured.

    `step(mode)` puts it in effect on this thread for one step: "capture"
    captures each region the step calls (and replays it at once, so the
    step's outputs are real), "replay" replays each region that fits,
    "eager" runs every region eagerly (the session does not engage)."""

    def __init__(self):
        self.regions: Dict[Tuple[str, int], _Region] = {}
        self.mode: Optional[str] = None
        self.inside = False  # a region's body runs (regions do not nest)
        self._seen: Dict[str, int] = {}
        self._stable: set = set()
        self._persistent: Dict[int, torch.Tensor] = {}  # storage pointer -> a buffer in it
        self._pool = None

    def stable(self, *trees) -> None:
        """The tensors of `trees` (dicts, lists, tuples), which the session
        holds for its life: the regions that take them read them in place."""
        leaves: List[torch.Tensor] = []
        _flatten(trees, leaves)
        self._stable.update(t.untyped_storage().data_ptr() for t in leaves)

    @contextlib.contextmanager
    def step(self, mode: str):
        prev = getattr(_local, "graphs", None)
        _local.graphs, self.mode, self._seen = self, mode, {}
        try:
            yield self
        finally:
            _local.graphs, self.mode = prev, None

    def call(self, name: str, fn: Callable, args: Tuple):
        k = self._seen.get(name, 0)
        self._seen[name] = k + 1
        self.inside = True
        try:
            if self.mode == "capture":
                return self._capture((name, k), fn, args)
            r = self.regions.get((name, k)) if self.mode == "replay" else None
            out = _MISS if r is None else r.replay(args)
            if out is not _MISS:
                tracing.count("graph_replays")
                return out
            tracing.count("graph_eager")
            return fn(*args)
        finally:
            self.inside = False

    def _keep(self, t: torch.Tensor) -> None:
        self._persistent.setdefault(t.untyped_storage().data_ptr(), t)

    def _capture(self, key, fn: Callable, args: Tuple):
        leaves: List[torch.Tensor] = []
        spec = _flatten(args, leaves)
        inputs, kinds = [], []
        for x in leaves:
            ptr = x.untyped_storage().data_ptr()
            if ptr in self._persistent:
                inputs.append(x)
                kinds.append(_ALIAS)
            elif ptr in self._stable:
                inputs.append(x)
                kinds.append(_STABLE)
            else:
                inputs.append(x.clone())
                kinds.append(_OWN)
                self._keep(inputs[-1])
        static_args = _unflatten(spec, iter(inputs))
        global_hooks = _global_hooks()
        called: List[torch.nn.Module] = []
        handle = _module.register_module_forward_pre_hook(lambda m, a: called.append(m))
        counters = tracing.launch_counters()
        before = [f.launches for f in counters]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                out = fn(*static_args)
        finally:
            handle.remove()
        r = _Region()
        r.graph, r.spec, r.inputs, r.kinds = graph, spec, inputs, kinds
        outputs: List[torch.Tensor] = []
        r.out_spec, r.outputs = _flatten(out, outputs), outputs
        for t in outputs:
            self._keep(t)
        mods = list({id(m): m for m in called}.values())
        dicts = [d for m in mods for d in (m._forward_pre_hooks, m._forward_hooks)]
        r.empty = [d for d in dicts if not d]
        r.hooks = [(d, tuple(d)) for d in dicts if d]
        r.global_hooks = global_hooks
        r.launches = [(f, f.launches - n) for f, n in zip(counters, before) if f.launches != n]
        graph.replay()
        self.regions[key] = r
        return out

    def unshared(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """`out` with a copy of each tensor that lies in a region's buffer."""
        if not self._persistent:
            return out
        return {k: v.clone() if isinstance(v, torch.Tensor)
                and v.untyped_storage().data_ptr() in self._persistent else v
                for k, v in out.items()}
