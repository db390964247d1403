"""The traced window: ``torch.profiler`` over the device and the host, and
what the per-layer readers take from it.

From the profiler's raw events (no tree is built, so a window of tens of
thousands of kernels is read in seconds):

- ``busy_s`` per device: the union of the intervals in which an operation
  (kernel, copy or fill) ran on that device, clipped to the window;
- ``kernel_s`` by name, summed over the window and the devices;
- ``launches``: the host calls that put work on a stream, the pattern
  copied from the program's profiling module (a CUDA graph's launch is one
  call, whatever it holds);
- ``idle_gaps``: every stretch of device 0's idle time, named by the
  innermost host operation running when it began ("python" where none
  was), summed by name.
"""

from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict

import torch

# the CUDA API calls (cuda* and cu*) that put work on a stream
LAUNCH_CALLS = re.compile(
    r"cu(da)?(LaunchKernel\w*|GraphLaunch|Memcpy\w*Async|Memset\w*Async)")


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def _is_device(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    annot = getattr(e, "is_user_annotation", None)
    return not (annot is not None and annot())


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Window:
    """``with Window(devices) as w: ...``: profiles the block and, after
    it, synchronises every device and reads the trace into ``w.summary``.
    Inactive (``enabled`` False): times the block only."""

    def __init__(self, devices: list[torch.device], enabled: bool = True):
        self.devices = devices
        self.enabled = enabled
        self.prof = None
        self.summary: dict = {}
        self.wall_s = 0.0

    def _sync(self):
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def __enter__(self):
        self._sync()
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(
                    self.prof.profiler.kineto_results.events(),
                    [d.index for d in self.devices])
        return False


def summarize(events, device_ids: list[int]) -> dict:
    """Busy seconds per device, kernel seconds by name, host launches by
    call, and device 0's idle gaps by host operation."""
    dev_iv: dict[int, list[tuple[int, int]]] = defaultdict(list)
    kernel_s: dict[str, float] = defaultdict(float)
    launches: dict[str, int] = defaultdict(int)
    host: list[tuple[int, int, str]] = []
    t_lo, t_hi = None, None
    for e in events:
        s, d = _ns(e, "start"), _ns(e, "duration")
        name = e.name()
        if _is_device(e):
            dev_iv[e.device_index()].append((s, s + d))
            kernel_s[name] += d * 1e-9
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            if LAUNCH_CALLS.fullmatch(name):
                launches[name] += 1
            host.append((s, s + d, name))
            t_lo = s if t_lo is None else min(t_lo, s)
            t_hi = s + d if t_hi is None else max(t_hi, s + d)
    busy = {}
    for i in device_ids:
        busy[i] = sum(e - s for s, e in _merge(dev_iv.get(i, []))) * 1e-9
    gaps: dict[str, float] = defaultdict(float)
    first = device_ids[0]
    merged = _merge(dev_iv.get(first, []))
    if merged and host:
        host.sort()
        starts = [h[0] for h in host]
        edges = [(t_lo, merged[0][0])] + [
            (merged[k][1], merged[k + 1][0]) for k in range(len(merged) - 1)
        ] + [(merged[-1][1], t_hi)]
        for g0, g1 in edges:
            if g1 <= g0:
                continue
            gaps[_host_at(host, starts, g0)] += (g1 - g0) * 1e-9
    return {"busy_s": busy, "kernel_s": dict(kernel_s),
            "launches": dict(launches), "idle_gaps": dict(gaps)}


def _host_at(host, starts, t: int) -> str:
    """The innermost host operation running at ``t`` (the latest-started of
    those that cover it, among the 64 that started last before it)."""
    k = bisect.bisect_right(starts, t)
    for j in range(k - 1, max(k - 65, -1), -1):
        s, e, name = host[j]
        if s <= t < e:
            return name
    return "python"


def breakdown(summary: dict) -> dict:
    """The 10 device operations that took most time, and the 10 longest
    idle sums by host operation."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(summary.get("kernel_s", {})),
            "idle_gaps": top(summary.get("idle_gaps", {}))}
