"""The port's own spans and counters along the serving path, off unless
asked for:

    from veon_tpu_torch.utils import tracing

    tracing.enable()                  # or serve under a recording torch.profiler
    handler(**request)                # entry.ServeHandler
    rec = tracing.requests()[-1]      # {"id", "spans", "counters", "launches"}
    tracing.disable()

A span (`span(name)`) marks one layer's call. Off, it reads one module
flag and returns one shared no-op: no clock, no allocation, no event. On,
it opens `torch.profiler.record_function(name)` (so any profiler that
records the thread puts it on its own timeline), records its name, its
request and its parent span, its host start and end in unix-epoch ns
(`time.time_ns()`, the base of the profiler's timeline) and, where CUDA
is initialized, a pair of CUDA events, whose device ms are resolved when
the tracer is read, never inside a request.

A counter adds to the innermost open span and to its request:
`h2d_bytes` and `h2d_copies` at the serving path's uploads (`uploaded`,
whatever the device), `d2h_bytes` at its readbacks (`read_back`), and
`host_syncs`, each call that made the host wait for the card: PyTorch's
sync debug mode warns at every such call while a traced request computes
on its thread (`attach`), and each warning is counted where it happens
and not shown (other warnings are shown once the request is done);
`clip_token_layers` in each `clip.blocks` span (`nn/vit.py`). A
request also holds its kernel launches, the deltas of the `.launches`
counters of `ops/bev_pool.py`, `ops/fused_ln.py` and `ops/deform_stencil.py`.

Tracing is on after `enable()`, and for each request that reaches
`ServeHandler` while a `torch.profiler` records, on any thread and in
either mode (`request`). A request's spans may lie on two threads:
`request()` opens `serve.request` on the caller's thread and `attach()`
hangs the worker's spans under it. A span opened outside any request (a
session called directly) starts a request of its own. Nothing is
recorded while `torch.compiler.is_compiling()`, so exported programs hold
no span. Set-up spans (`setup_span`) are recorded in every process, host
clock only.

The last `RING` requests and set-up spans stay in memory (`requests()`,
`setup()`); the tracer writes no file (`utils/profiling.py` `trace`
writes the operator's Chrome trace).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING = 256
SYNC_WARNING = "called a synchronizing CUDA operation"

_enabled = False  # enable()
_on = False  # _enabled, or a request traced for a recording profiler in flight
_traced = 0  # such requests in flight
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans, innermost last
_ids = itertools.count(1)
_requests: collections.deque = collections.deque(maxlen=RING)
_setup: collections.deque = collections.deque(maxlen=RING)
_capture = None  # the sync warnings' capture while a traced request computes
_shown: Dict = {}  # the registry of warnings shown again after a request


class _NoOp:
    """What `span`, `request` and `attach` give with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()


def enable() -> None:
    """Trace every span from now on, in every thread."""
    global _enabled, _on
    with _lock:
        _enabled = _on = True


def disable() -> None:
    """Stop tracing (requests traced for a recording profiler go on)."""
    global _enabled, _on
    with _lock:
        _enabled = False
        _on = _traced > 0


def clear() -> None:
    """Forget the requests kept so far."""
    _requests.clear()


def _stack() -> List:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _launch_counts() -> Dict[str, int]:
    from ..ops import bev_pool, deform_stencil, fused_ln

    return {f.__name__: f.launches for f in (bev_pool.bev_pool_pooled, bev_pool.bev_pool_sorted,
                                             bev_pool.bev_pool_sorted2, fused_ln.ln_dense,
                                             deform_stencil.deform_stencil)}


class _Request:
    __slots__ = ("id", "spans", "counters", "launches", "_record")

    def __init__(self):
        self.id = next(_ids)
        self.spans: List[_Span] = []
        self.counters: Dict[str, int] = {}
        self.launches = _launch_counts()
        self._record = None

    def finish(self) -> None:
        now = _launch_counts()
        self.launches = {k: now[k] - v for k, v in self.launches.items()}
        _requests.append(self)

    def record(self) -> Dict:
        if self._record is None:
            self._record = {"id": self.id, "spans": [s.record() for s in self.spans],
                            "counters": dict(self.counters), "launches": dict(self.launches)}
        return self._record


def _add(span: "_Span", name: str, n: int) -> None:
    span.counters[name] = span.counters.get(name, 0) + n
    c = span.req.counters
    c[name] = c.get(name, 0) + n


class _Span:
    __slots__ = ("name", "req", "parent", "index", "thread", "t0", "t1", "counters", "own",
                 "_rf", "_ev")

    def __init__(self, name: str, root: bool = False):
        self.name, self.counters, self._ev = name, {}, None
        self.req = _Request() if root else None
        self.own = False

    def __enter__(self):
        stack = _stack()
        if self.req is not None:  # the root of a request of its own
            self.parent = None
        elif stack:
            top = stack[-1]
            _drain(top)
            self.req, self.parent = top.req, top.index
        else:  # opened outside any request: a request of its own
            self.req, self.parent, self.own = _Request(), None, True
            _capture_start()
        self.index = len(self.req.spans)
        self.req.spans.append(self)
        self.thread = threading.current_thread().name
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.t0 = time.time_ns()
        if torch.cuda.is_initialized():
            self._ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._ev[0].record()
        return self

    def __exit__(self, *exc):
        if self._ev is not None:
            self._ev[1].record()
        self.t1 = time.time_ns()
        self._rf.__exit__(None, None, None)
        _drain(self)
        _stack().pop()
        if self.own:
            _capture_stop()
        if self.parent is None:
            self.req.finish()
        return False

    def record(self) -> Dict:
        device_ms = None
        if self._ev is not None:
            self._ev[1].synchronize()
            device_ms = self._ev[0].elapsed_time(self._ev[1])
        return {"name": self.name, "parent": self.parent, "thread": self.thread,
                "t0_ns": self.t0, "t1_ns": self.t1, "host_ms": (self.t1 - self.t0) * 1e-6,
                "device_ms": device_ms, "counters": dict(self.counters)}


def span(name: str):
    """A context manager that records the body as the span `name` when
    tracing is on, and does nothing otherwise."""
    if not _on or torch.compiler.is_compiling():
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` of the innermost open span and its request."""
    if not _on or torch.compiler.is_compiling():
        return
    stack = _stack()
    if stack:
        _add(stack[-1], name, n)


def uploaded(t: torch.Tensor) -> torch.Tensor:
    """Count t, just copied from the host to the serving device, as one
    upload of its bytes; returns t."""
    if _on and not torch.compiler.is_compiling():
        count("h2d_bytes", t.nbytes)
        count("h2d_copies", 1)
    return t


def read_back(t: torch.Tensor) -> torch.Tensor:
    """Count t, just copied from the device to the host, as read back;
    returns t."""
    if _on and not torch.compiler.is_compiling():
        count("d2h_bytes", t.nbytes)
    return t


class _Profiled(_Span):
    """The root span of a request traced because a profiler records."""

    __slots__ = ()

    def __enter__(self):
        global _traced, _on
        with _lock:
            _traced += 1
            _on = True
        return super().__enter__()

    def __exit__(self, *exc):
        global _traced, _on
        try:
            return super().__exit__(*exc)
        finally:
            with _lock:
                _traced -= 1
                _on = _enabled or _traced > 0


def request(name: str = "serve.request"):
    """The root span of one served request on the caller's thread, when
    tracing is on or a `torch.profiler` records (tracing is then on for
    this request alone); yields the span to hand to `attach`, or None."""
    if _enabled:
        return _Span(name, root=True)
    if _autograd_profiler._is_profiler_enabled:
        return _Profiled(name, root=True)
    return _NOOP


class _Attach:
    __slots__ = ("root",)

    def __init__(self, root: _Span):
        self.root = root

    def __enter__(self):
        _stack().append(self.root)
        _capture_start()
        return self.root

    def __exit__(self, *exc):
        _drain(self.root)
        _stack().pop()
        _capture_stop()
        return False


def attach(root: Optional[_Span]):
    """Hang this thread's spans under `root` (what `request` yielded on
    the caller's thread) while the request computes here, and count the
    host's waits for the card; nothing when root is None."""
    return _NOOP if root is None else _Attach(root)


class _Capture:
    __slots__ = ("cm", "log", "seen", "other", "mode", "users")


def _capture_start() -> None:
    """Count the host's waits for the card from now on: the sync debug
    mode's warnings (CUDA only), each caught and shown to no one."""
    global _capture
    with _lock:
        if _capture is not None:
            _capture.users += 1
            return
        cap = _Capture()
        cap.cm = warnings.catch_warnings(record=True)
        cap.log = cap.cm.__enter__()
        warnings.simplefilter("always")
        cap.seen, cap.other, cap.users, cap.mode = 0, [], 1, None
        if torch.cuda.is_initialized():
            cap.mode = torch.cuda.get_sync_debug_mode()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the mode's notice that it is a prototype
                torch.cuda.set_sync_debug_mode("warn")
        _capture = cap


def _capture_stop() -> None:
    global _capture
    with _lock:
        cap = _capture
        cap.users -= 1
        if cap.users:
            return
        _capture = None
        if cap.mode is not None:
            torch.cuda.set_sync_debug_mode(cap.mode)
        cap.cm.__exit__(None, None, None)
    for w in cap.other + cap.log[cap.seen:]:
        if SYNC_WARNING not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno,
                                   registry=_shown)


def _drain(span: _Span) -> None:
    """Count the waits caught since the last look into `span`."""
    cap = _capture
    if cap is None or len(cap.log) == cap.seen:
        return
    with _lock:
        n = len(cap.log)
        for w in cap.log[cap.seen:n]:
            if SYNC_WARNING in str(w.message):
                _add(span, "host_syncs", 1)
            else:
                cap.other.append(w)
        cap.seen = n


class _SetupSpan:
    __slots__ = ("rec",)

    def __init__(self, name: str):
        self.rec = {"name": name}

    def __enter__(self):
        st = getattr(_local, "setup", None)
        if st is None:
            st = _local.setup = []
        self.rec.update(id=next(_ids), parent=st[-1]["id"] if st else None,
                        t0_ns=time.time_ns())
        st.append(self.rec)
        _setup.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec["t1_ns"] = time.time_ns()
        self.rec["host_s"] = (self.rec["t1_ns"] - self.rec["t0_ns"]) * 1e-9
        _local.setup.pop()
        return False


def setup_span(name: str) -> _SetupSpan:
    """A set-up step, recorded in every process on the host clock."""
    return _SetupSpan(name)


def requests() -> List[Dict]:
    """The kept requests, oldest first, each {"id", "spans", "counters",
    "launches"}; each span {"name", "parent" (an index into the request's
    spans, or None), "thread", "t0_ns", "t1_ns", "host_ms", "device_ms"
    (None without CUDA), "counters"}. Resolves the device ms of requests
    not read before, which waits for their last event."""
    return [r.record() for r in list(_requests)]


def setup() -> List[Dict]:
    """The kept set-up spans that have ended, in the order they began:
    {"name", "id", "parent" (an id or None), "t0_ns", "t1_ns", "host_s"}."""
    return [dict(r) for r in list(_setup) if "t1_ns" in r]
