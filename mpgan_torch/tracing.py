"""Spans: named stretches of the program's work, at its layer boundaries.

    with tracing.span("upscale.share", device=dev, card=1, pass_no=2):
        ...

A span records its name, its host start and end on ``time.time_ns()``
(the clock of ``torch.profiler``'s events), the span open on the same
thread when it began (its parent), the thread and its keyword attributes,
to which it adds its parent's (a pass's number reaches every span inside
the pass).
Given a CUDA ``device``, it also records a timing event on that device's
current stream at its start and at its end, so that its device interval,
and the gaps between spans on one card, can be read after the work ran.

Tracing is on while :func:`enable` is in force, or while a
``torch.profiler`` session is active; then a span also opens a
``record_function`` range of its name, which lands in the profiler's trace
beside the kernels, on the same clock, with its device-side projection.
Off, a span is one check and a shared null context. Inside a CUDA graph
capture a span records nothing: a capture is not a run, and a replay runs
no Python.

Finished spans go into a bounded store (the newest ``STORE_LEN``);
:func:`spans` resolves their events and returns them, :func:`clear`
empties it. There is no exporter of its own: the profiler's trace is the
file to read.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque

import torch

# spans the store keeps, the newest
STORE_LEN = 1 << 16

_enabled = False
_store: deque = deque(maxlen=STORE_LEN)
_ids = itertools.count(1)
_local = threading.local()
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def enable():
    """Tracing on while the block runs (the previous state after it)."""
    global _enabled
    saved, _enabled = _enabled, True
    try:
        yield
    finally:
        _enabled = saved


def span(name: str, device=None, **attrs):
    """A context manager that records the block as a span (module
    docstring); ``device``, a CUDA device, adds its device interval."""
    if not (_enabled or _profiling()):
        return _NULL
    return _Span(name, device, attrs)


def _capturing() -> bool:
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "attrs", "id", "parent", "t0", "ev0",
                 "range")

    def __init__(self, name, device, attrs):
        self.name, self.attrs = name, attrs
        self.device = None
        if device is not None and torch.device(device).type == "cuda":
            device = torch.device(device)
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.device = device
        self.range = self.ev0 = None

    def __enter__(self):
        if _capturing():
            self.id = None
            return self
        stack = _stack()
        self.id = next(_ids)
        self.parent = None
        if stack:
            self.parent = stack[-1].id
            self.attrs = {**stack[-1].attrs, **self.attrs}
        stack.append(self)
        self.t0 = time.time_ns()
        if _profiling():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        if self.device is not None:
            self.ev0 = _event(self.device)
        return self

    def __exit__(self, *exc):
        if self.id is None:
            return False
        ev1 = _event(self.device) if self.device is not None else None
        if self.range is not None:
            self.range.__exit__(*exc)
        t1 = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _store.append((self.id, self.parent, self.name,
                       threading.get_native_id(), self.attrs, self.t0, t1,
                       self.device, self.ev0, ev1))
        return False


def _event(device: torch.device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def spans() -> list[dict]:
    """The stored spans, oldest first, each a dict: ``id``, ``parent``
    (the id of the span open on its thread when it began, or None),
    ``name``, ``thread`` (native id), ``attrs``, ``host_start_ns``,
    ``host_end_ns`` (``time.time_ns()``), ``device`` (its CUDA device's
    index, or None) and, on a device, ``device_start_ms`` and
    ``device_end_ms``: milliseconds from the start of the first span in
    the store on the same device. Waits for each span's device work to
    finish."""
    rows = list(_store)
    base: dict[int, torch.cuda.Event] = {}
    out = []
    for sid, parent, name, thread, attrs, t0, t1, dev, ev0, ev1 in rows:
        row = {"id": sid, "parent": parent, "name": name, "thread": thread,
               "attrs": dict(attrs), "host_start_ns": t0,
               "host_end_ns": t1, "device": None}
        if dev is not None:
            ev1.synchronize()
            first = base.setdefault(dev.index, ev0)
            row.update(device=dev.index,
                       device_start_ms=first.elapsed_time(ev0),
                       device_end_ms=first.elapsed_time(ev1))
        out.append(row)
    return out


def clear() -> None:
    """Empty the store."""
    _store.clear()
