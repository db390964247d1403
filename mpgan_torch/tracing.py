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
Off, a span is one check and a shared null context.

Inside a CUDA graph capture a span stores nothing: a capture is not a run,
and a replay runs no Python. Where the capture runs under :func:`capture`
(:class:`mpgan_torch.train.graphed.Graph` does), a span given a card
records instead two timing events into the graph, external ones
(``cudaEventRecordExternal``), so that each replay records them on the
card; it does so whether or not tracing is on, since a program is captured
before the window that traces it. The :class:`Captured` that the block
yields, held by the graph, keeps them in capture order, with the parents
and attributes the spans had among themselves. A replay runs under
:func:`replay`: with tracing on, it records an event of its own start,
launches, and becomes the graph's pending replay in place of the one
before, whose events this launch records anew; no replay waits on
another. :func:`spans` reads each graph's pending replay, once its events
have been recorded on the card, into the store: one row per captured
span, with the replay's host start and end (the launch's), its device
interval from the events, and as its parent the span open when the
replay began. So a traced window gives the rows of each program's last
traced replay (call :func:`spans` after each replay to have them all).
With tracing off a replay reads nothing and forgets the pending one.

Finished spans go into a bounded store (the newest ``STORE_LEN``);
:func:`spans` resolves their events and returns them, :func:`clear`
empties it. There is no exporter of its own: the profiler's trace is the
file to read.

Launch counters: a kernel wrapper that counts its launches in a module
global registers it by name in :data:`COUNTERS`
(:func:`count_launches`), so that a CUDA graph's capture, which records
launches without running them, can put every counter back and each of its
replays add what it recorded (:class:`mpgan_torch.train.graphed.Graph`).
"""

from __future__ import annotations

import contextlib
import itertools
import sys
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
# the Captured whose last replay was traced and is not read yet
_unread: set = set()
# name → (module, attribute) of each kernel wrapper's launch counter
COUNTERS: dict = {}


def count_launches(module: str, **counters: str) -> None:
    """Register the launch counters of the module named ``module``:
    ``name=attribute``, each attribute a module-level int that its
    wrappers add their launches to."""
    mod = sys.modules[module]
    COUNTERS.update((name, (mod, attr)) for name, attr in counters.items())


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
    if _enabled or _profiling():
        return _Span(name, device, attrs)
    if device is not None and getattr(_local, "captured", None) is not None:
        return _Span(name, device, attrs)
    return _NULL


def _capturing() -> bool:
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Captured:
    """The spans one CUDA graph capture recorded into its graph (module
    docstring): ``rows``, in capture order, each ``[name, attrs, parent
    (an index into rows, or None), device, start event, end event]``; and
    the last traced replay whose events are not read yet."""

    __slots__ = ("rows", "stack", "pending")

    def __init__(self):
        self.rows: list[list] = []
        self.stack: list[int] = []
        self.pending = None

    def open(self, name: str, attrs: dict, device, ev0) -> int:
        parent = self.stack[-1] if self.stack else None
        if parent is not None:
            attrs = {**self.rows[parent][1], **attrs}
        self.rows.append([name, attrs, parent, device, ev0, None])
        self.stack.append(len(self.rows) - 1)
        return len(self.rows) - 1

    def close(self, index: int, ev1) -> None:
        self.rows[index][5] = ev1
        if self.stack and self.stack[-1] == index:
            self.stack.pop()


@contextlib.contextmanager
def capture():
    """The block captures a CUDA graph on this thread: a span given a card
    records its events into the graph → the :class:`Captured` holding
    them."""
    held = getattr(_local, "captured", None)
    _local.captured = Captured()
    try:
        yield _local.captured
    finally:
        _local.captured = held


def replay(captured: Captured | None):
    """The context of one replay of a graph whose capture recorded
    ``captured`` (module docstring)."""
    if captured is None or not captured.rows:
        return _NULL
    if not (_enabled or _profiling()):
        captured.pending = None
        return _NULL
    return _Replay(captured)


class _Replay:
    __slots__ = ("cap", "parent", "attrs", "t0", "ev")

    def __init__(self, cap: Captured):
        self.cap = cap

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.attrs = stack[-1].attrs if stack else {}
        self.t0 = time.time_ns()
        self.ev = _event(self.cap.rows[0][3])
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.cap.pending = (self.ev, self.t0, time.time_ns(),
                                self.parent, self.attrs,
                                threading.get_native_id())
            _unread.add(self.cap)
        return False


def _read(cap: Captured) -> None:
    """The rows of ``cap``'s pending replay into the store, once its events
    have been recorded on the card."""
    pending, cap.pending = cap.pending, None
    _unread.discard(cap)
    if pending is None:
        return
    ev, t0, t1, parent, attrs, thread = pending
    for row in cap.rows:
        row[5].synchronize()
    ids = [next(_ids) for _ in cap.rows]
    for sid, (name, own, up, dev, ev0, ev1) in zip(ids, cap.rows):
        _store.append((sid, parent if up is None else ids[up], name, thread,
                       {**attrs, **own}, t0, t1, dev, ev,
                       (ev.elapsed_time(ev0), ev.elapsed_time(ev1))))


class _Span:
    __slots__ = ("name", "device", "attrs", "id", "parent", "t0", "ev0",
                 "range", "captured")

    def __init__(self, name, device, attrs):
        self.name, self.attrs = name, attrs
        self.device = None
        if device is not None and torch.device(device).type == "cuda":
            device = torch.device(device)
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.device = device
        self.range = self.ev0 = self.captured = None

    def __enter__(self):
        self.id = None
        if _capturing():
            cap = getattr(_local, "captured", None)
            if cap is not None and self.device is not None:
                self.captured = (cap, cap.open(
                    self.name, self.attrs, self.device,
                    _event(self.device, external=True)))
            return self
        if not (_enabled or _profiling()):
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
        if self.captured is not None:
            cap, index = self.captured
            cap.close(index, _event(self.device, external=True))
            return False
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


def _event(device: torch.device, external: bool = False) -> torch.cuda.Event:
    ev = (torch.cuda.Event(enable_timing=True, external=True) if external
          else torch.cuda.Event(enable_timing=True))
    ev.record(torch.cuda.current_stream(device))
    return ev


def spans() -> list[dict]:
    """The stored spans, oldest first, each a dict: ``id``, ``parent``
    (the id of the span open on its thread when it began, or None),
    ``name``, ``thread`` (native id), ``attrs``, ``host_start_ns``,
    ``host_end_ns`` (``time.time_ns()``), ``device`` (its CUDA device's
    index, or None) and, on a device, ``device_start_ms`` and
    ``device_end_ms``: milliseconds from the start of the first span in
    the store on the same device. Reads the last traced replay of every
    captured program first (a captured span's row enters the store when
    it is read), and waits for each span's device work to finish."""
    for cap in list(_unread):
        _read(cap)
    rows = list(_store)
    base: dict[int, torch.cuda.Event] = {}
    out = []
    for sid, parent, name, thread, attrs, t0, t1, dev, ev0, ev1 in rows:
        row = {"id": sid, "parent": parent, "name": name, "thread": thread,
               "attrs": dict(attrs), "host_start_ns": t0,
               "host_end_ns": t1, "device": None}
        if dev is not None:
            if isinstance(ev1, tuple):
                # a captured span: ms from its replay's start event ``ev0``
                first = base.setdefault(dev.index, ev0)
                at = first.elapsed_time(ev0)
                start, end = at + ev1[0], at + ev1[1]
            else:
                ev1.synchronize()
                first = base.setdefault(dev.index, ev0)
                start, end = first.elapsed_time(ev0), first.elapsed_time(ev1)
            row.update(device=dev.index, device_start_ms=start,
                       device_end_ms=end)
        out.append(row)
    return out


def clear() -> None:
    """Empty the store, and forget the replays not read yet."""
    for cap in _unread:
        cap.pending = None
    _unread.clear()
    _store.clear()
