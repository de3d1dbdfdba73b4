"""The traced run's instruments, all placed from outside the program:
CUDA events around module calls (`StageTimer`), a host clock on a method
of an instance (`wrap_clocks`), and `torch.profiler` over a short
stretch (`profile_stretch`), read into the device's busy time, kernel
times by name and the idle gaps by what the host was doing."""

from __future__ import annotations

import collections
import heapq
import time
from typing import Callable, Dict, List


class StageTimer:
    """CUDA events before and after each call of the named modules (and
    wrapped methods), grouped per request by `end_item`."""

    def __init__(self, torch):
        self.torch = torch
        self.on = False
        self._open: Dict[str, list] = collections.defaultdict(list)
        self._cur: List = []
        self.items: List[List] = []

    def _event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self, name: str) -> None:
        if self.on:
            self._open[name].append(self._event())

    def stop(self, name: str) -> None:
        if self.on and self._open[name]:
            self._cur.append((name, self._open[name].pop(), self._event()))

    def hook(self, module, name: str) -> None:
        module.register_forward_pre_hook(lambda m, a: self.start(name))
        module.register_forward_hook(lambda m, a, o: self.stop(name))

    def wrap(self, obj, attr: str, name: str) -> None:
        fn = getattr(obj, attr)

        def timed(*a, **k):
            self.start(name)
            out = fn(*a, **k)
            self.stop(name)
            return out

        setattr(obj, attr, timed)

    def end_item(self) -> None:
        if self.on:
            self.items.append(self._cur)
        self._cur = []

    def spans_ms(self) -> List[Dict[str, float]]:
        """Per item: the summed ms of each named span (after a synchronize)."""
        self.torch.cuda.synchronize()
        out = []
        for item in self.items:
            d: Dict[str, float] = collections.defaultdict(float)
            for name, a, b in item:
                d[name] += a.elapsed_time(b)
            out.append(dict(d))
        return out


def wrap_clocks(obj, attr: str, sink: List) -> None:
    """Append (host clock at entry, host clock at return) to `sink` for
    each call of obj.attr."""
    fn = getattr(obj, attr)

    def clocked(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sink.append((t0, time.perf_counter()))
        return out

    setattr(obj, attr, clocked)


def short_name(name: str, width: int = 100) -> str:
    """A kernel's name without its argument list, at most `width` letters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:width]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_stretch(torch, run: Callable[[], int]) -> Dict:
    """Profile `run()` (which returns the number of items it ran) from a
    synchronized start to a synchronized end. Returns the stretch's wall
    time (`window_s`), the union of device activity (`busy_s`), device
    seconds and launches per kernel name, the ten largest device
    operations, and the ten largest sums of idle gaps by the innermost
    host operation running at the gap's start (none: Python between host
    operations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = run()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CPU and tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    merged = _merge([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) * 1e-6
    per_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        per_name[name][0] += (e - s) * 1e-6
        per_name[name][1] += 1
    gaps: Dict[str, float] = collections.defaultdict(float)
    host.sort()
    active, i = [], 0  # heap of (duration, end, name); an entry ended is ended for good
    for (_s0, e0), (s1, _e1) in zip(merged, merged[1:]):
        while i < len(host) and host[i][0] <= e0:
            hs, he, name = host[i]
            heapq.heappush(active, (he - hs, he, name))
            i += 1
        while active and active[0][1] <= e0:
            heapq.heappop(active)
        gaps[active[0][2] if active else "python, between host ops"] += (s1 - e0) * 1e-6
    return {"window_s": window, "busy_s": busy, "items": n,
            "kernels": {k: tuple(v) for k, v in per_name.items()},
            "device_ops": sorted(([short_name(k), v[0]] for k, v in per_name.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10]}


def kernel_seconds_per_launch(kernels: Dict, match: Callable[[str], bool]):
    """(device seconds, launches) of the kernels whose name `match`es."""
    secs = sum(v[0] for k, v in kernels.items() if match(k))
    n = sum(v[1] for k, v in kernels.items() if match(k))
    return secs, n
