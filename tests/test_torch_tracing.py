"""The port's spans (mpgan_torch.tracing) and the benchmark's readers of them.

- Off (neither ``tracing.enable()`` nor a profiler session): a span stores
  nothing and opens no ``record_function`` range, alone and on the
  trainer's and the split upscaler's paths.
- On: names, parents (per thread), attributes (a parent's reach its
  children), threads; the store keeps the newest ``STORE_LEN``; a span
  whose block raises is stored.
- Under a CPU ``torch.profiler`` session: the span is a range of its name
  among the profiler's events, starting within 5 ms of the store's start.
- The program's spans on the CPU: ``Trainer.fit`` stepping eagerly and
  through the graphed programs (the capture primitive stubbed), and a
  graphed upscaler split over ``cpu:0..2`` as distinct cards.
- Each reader of ``port_bench/metrics/`` over a synthetic span list with a
  known answer, and None on an empty list or where the program has no
  spans.
- On a card (marked ``cuda``; skipped without one): a span inside a CUDA
  graph capture records nothing, and a replay's span has a device
  interval. No JAX is imported here, so on a card's machine ``python -m
  pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -m
  cuda`` runs it.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter, deque

import numpy as np
import pytest
import torch

from mpgan_torch import tracing
from mpgan_torch.infer import assemble
from mpgan_torch.models import generator as TG
from mpgan_torch.train import graphed, losses
from mpgan_torch.train import loop as tloop
from port_bench import manifest
from port_bench import spans as sp
from test_torch_graphed import StubGraph, _config, _tc

torch.set_num_threads(1)

READERS = ("upscaler.host_ms_per_frame", "upscaler.share_ms_per_frame",
           "upscaler.card0_only_ms_per_frame", "train.replay_gap_pct",
           "train.launch_us_per_step")


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


@pytest.fixture
def ranges(monkeypatch):
    """Counts the ``record_function`` ranges entered."""
    entered = Counter()
    real = torch.profiler.record_function

    class Counted(real):
        def __enter__(self):
            entered[self.name] += 1
            return super().__enter__()
    monkeypatch.setattr(torch.profiler, "record_function", Counted)
    return entered


class CardGraph:
    """The capture primitive's stand-in for the upscaler: runs the
    function at the capture and at each replay, its replays writing into
    the capture's outputs."""

    @staticmethod
    def available(device):
        return True

    def __init__(self, fn, device, generator=None):
        self.fn, self.device = fn, device
        self.out = fn()
        self.launches = (0, 0)

    def replay(self):
        self.out.copy_(self.fn())
        return self.out

    def reset(self):
        self.out = None


def _split_upscaler(monkeypatch, k=3):
    monkeypatch.setattr(graphed, "Graph", CardGraph)
    torch.manual_seed(0)
    g1, g2 = TG.make_pass1(2, 8, 1).eval(), TG.make_pass2(2, 8, 1).eval()
    up = assemble.make_graphed_upscaler(
        g1, g2, 4, devices=[torch.device("cpu", i) for i in range(k)])
    frame = torch.from_numpy(np.random.default_rng(3).random(
        (6, 8, 8, 4), dtype=np.float32))
    return up, frame


def _triplet():
    g = torch.Generator().manual_seed(0)
    p, c, n = (torch.rand((2, 8, 8, 1), generator=g) for _ in range(3))
    return p, c, n, torch.randn((2, 8, 8, 2), generator=g)


# ------------------------------------------------------------------ off


def test_off_span_stores_nothing_and_opens_no_range(ranges):
    assert tracing.span("a", device="cpu", x=1) is tracing.span("b")
    with tracing.span("a"):
        with tracing.span("b", card=1):
            pass
    assert tracing.spans() == [] and not ranges


def test_off_trainer_stores_nothing_and_opens_no_range(ranges):
    tr = tloop.Trainer(_config(), _tc(), device="cpu")
    tr.fit(2, log_every=1)
    losses.align_triplet(*_triplet(), use_kernel=True)
    assert tracing.spans() == [] and not ranges


def test_off_split_upscaler_stores_nothing_and_opens_no_range(
        monkeypatch, ranges):
    up, frame = _split_upscaler(monkeypatch)
    for _ in range(3):
        up(frame)
    assert tracing.spans() == [] and not ranges


# ------------------------------------------------------------------ on


def test_on_records_names_parents_attrs_and_threads(ranges):
    seen = {}

    def other():
        with tracing.span("t.other", card=2):
            seen["thread"] = threading.get_native_id()
    t0 = time.time_ns()
    with tracing.enable():
        with tracing.span("t.outer", pass_no=2):
            with tracing.span("t.inner", card=1):
                pass
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
        with tracing.span("t.after"):
            pass
    assert not th.is_alive()
    with tracing.span("t.off"):
        pass
    rows = {s["name"]: s for s in tracing.spans()}
    assert set(rows) == {"t.outer", "t.inner", "t.other", "t.after"}
    outer, inner = rows["t.outer"], rows["t.inner"]
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    assert rows["t.other"]["parent"] is None
    assert rows["t.after"]["parent"] is None
    assert inner["attrs"] == {"pass_no": 2, "card": 1}
    assert rows["t.other"]["attrs"] == {"card": 2}
    assert outer["thread"] == threading.get_native_id()
    assert rows["t.other"]["thread"] == seen["thread"] != outer["thread"]
    assert t0 <= outer["host_start_ns"] <= inner["host_start_ns"] \
        <= inner["host_end_ns"] <= outer["host_end_ns"]
    assert all(s["device"] is None for s in rows.values())
    # tracing.enable() alone opens no profiler range
    assert not ranges


def test_enable_nests_and_restores():
    with tracing.enable():
        with tracing.enable():
            pass
        with tracing.span("still.on"):
            pass
    with tracing.span("off.again"):
        pass
    assert [s["name"] for s in tracing.spans()] == ["still.on"]


def test_a_span_whose_block_raises_is_stored():
    with tracing.enable(), pytest.raises(ValueError):
        with tracing.span("outer"):
            with tracing.span("raises"):
                raise ValueError("x")
    rows = tracing.spans()
    assert [s["name"] for s in rows] == ["raises", "outer"]
    assert rows[0]["parent"] == rows[1]["id"]
    with tracing.enable(), tracing.span("next"):
        pass
    assert tracing.spans()[-1]["parent"] is None


def test_store_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tracing, "_store", deque(maxlen=5))
    with tracing.enable():
        for i in range(12):
            with tracing.span("s", i=i):
                pass
    assert [s["attrs"]["i"] for s in tracing.spans()] == list(range(7, 12))
    assert tracing.STORE_LEN == 1 << 16


def test_span_lands_among_the_profiler_events():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("t.profiled", card=0):
            torch.ones(64).sum()
    (row,) = tracing.spans()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "t.profiled"]
    assert len(events) == 1
    assert abs(events[0].start_ns() - row["host_start_ns"]) < 5_000_000
    # the profiler's session alone turned tracing on; after it, off
    with tracing.span("t.after"):
        pass
    assert len(tracing.spans()) == 1


# ------------------------------------------------------------ the program


def _tree(rows):
    by_id = {s["id"]: s for s in rows}
    return [(s["name"], by_id[s["parent"]]["name"] if s["parent"] else None)
            for s in rows]


def test_trainer_spans_stepping_eagerly():
    tr = tloop.Trainer(_config(), _tc(), device="cpu")
    with tracing.enable():
        tr.fit(2, log_every=2)
    rows = tracing.spans()
    steps = [s for s in rows if s["name"] == "train.step"]
    assert [s["attrs"]["it"] for s in steps] == [0, 1]
    tree = Counter(_tree(rows))
    # a D-run aligns the fake and real triplets, the G-run the fake one
    assert tree == Counter({("train.step", None): 2,
                            ("train.eager", "train.step"): 2,
                            ("warp.align", "train.eager"): 6,
                            ("train.read_metrics", "train.step"): 1})
    assert all(s["attrs"]["it"] in (0, 1) for s in rows)


def test_trainer_spans_through_the_graphed_programs(monkeypatch):
    StubGraph.log = []
    monkeypatch.setattr(graphed, "Graph", StubGraph)
    tr = tloop.Trainer(_config(), _tc(), device="cpu", graphs=True)
    with tracing.enable():
        tr.fit(4, log_every=4)
    tree = Counter(_tree(tracing.spans()))
    # step 0 is the first use of the program with R1, step 1 of the one
    # without, which step 2 captures and replays and step 3 replays
    assert tree[("train.eager", "train.step")] == 2
    assert tree[("train.replay", "train.step")] == 2
    assert tree[("train.read_metrics", "train.step")] == 1


def test_split_upscaler_spans_over_cpu_cards(monkeypatch):
    up, frame = _split_upscaler(monkeypatch, k=3)
    for _ in range(2):
        up(frame)
    with tracing.enable():
        up(frame)
    rows = tracing.spans()
    tree = Counter(_tree(rows))
    assert tree == Counter({("upscale.frame", None): 1,
                            ("upscale.pass", "upscale.frame"): 2,
                            ("upscale.scatter", "upscale.pass"): 6,
                            ("upscale.share", "upscale.pass"): 6,
                            ("upscale.gather", "upscale.pass"): 6,
                            # pass 1's concatenation, pass 2's velocity
                            # and concatenation
                            ("upscale.between", "upscale.pass"): 3})
    per = Counter((s["name"], s["attrs"].get("pass_no"),
                   s["attrs"].get("card")) for s in rows
                  if s["name"] != "upscale.frame")
    for p in (1, 2):
        for card in (0, 1, 2):
            for name in ("upscale.scatter", "upscale.share",
                         "upscale.gather"):
                assert per[(name, p, card)] == 1
    assert per[("upscale.between", 1, None)] == 1
    assert per[("upscale.between", 2, None)] == 2


# ----------------------------------------------------------- the readers


def _span(name, host_ms=0.0, dev=None, attrs=None):
    row = {"id": 0, "parent": None, "name": name, "thread": 1,
           "attrs": attrs or {}, "host_start_ns": 10 ** 9,
           "host_end_ns": 10 ** 9 + round(host_ms * 1e6), "device": None}
    if dev is not None:
        card, start, end = dev
        row.update(device=card, device_start_ms=start, device_end_ms=end)
    return row


SYNTHETIC = {
    # two frames of 2 and 4 host ms
    "upscaler.host_ms_per_frame": (
        [_span("upscale.frame", 2.0, (0, 0, 50)),
         _span("upscale.frame", 4.0, (0, 50, 90)),
         _span("upscale.share", 9.0, (0, 0, 10), {"card": 0})],
        {"units": 2, "window_s": 1.0}, 3.0),
    # two frames over two cards: card 0 10 ms a frame, card 1 8 + 1
    "upscaler.share_ms_per_frame": (
        [_span("upscale.share", 1, (0, 0, 10), {"card": 0}),
         _span("upscale.share", 1, (1, 0, 8), {"card": 1}),
         _span("upscale.gather", 1, (1, 9, 10), {"card": 1}),
         _span("upscale.share", 1, (0, 20, 30), {"card": 0}),
         _span("upscale.share", 1, (1, 20, 28), {"card": 1}),
         _span("upscale.gather", 1, (1, 29, 30), {"card": 1}),
         _span("upscale.between", 1, (0, 30, 31)),
         _span("upscale.share", 1, None, {"card": 2})],
        {"units": 2, "window_s": 1.0}, 9.5),
    "upscaler.card0_only_ms_per_frame": (
        [_span("upscale.scatter", 1, (0, 0, 1), {"card": 1}),
         _span("upscale.between", 1, (0, 9, 9.5)),
         _span("upscale.scatter", 1, (0, 10, 11), {"card": 1}),
         _span("upscale.between", 1, (0, 19, 19.5)),
         _span("upscale.share", 1, (1, 1, 9), {"card": 1})],
        {"units": 2, "window_s": 1.0}, 1.5),
    # gaps of 1 and 0.5 ms (the spans out of order) in a 0.1 s window
    "train.replay_gap_pct": (
        [_span("train.replay", 0.01, (0, 6, 11)),
         _span("train.replay", 0.01, (0, 0, 5)),
         _span("train.replay", 0.01, (0, 11.5, 16)),
         _span("train.step", 0.02)],
        {"units": 3, "window_s": 0.1}, 1.5),
    "train.launch_us_per_step": (
        [_span("train.replay", 0.010, (0, 0, 5)),
         _span("train.replay", 0.030, (0, 6, 11)),
         _span("train.step", 1.0)],
        {"units": 2, "window_s": 1.0}, 20.0),
}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_the_known_answer(name):
    rows, record, want = SYNTHETIC[name]
    assert manifest.reader(name)(record, rows) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_spans(name, monkeypatch):
    read = manifest.reader(name)
    record = {"units": 5, "window_s": 1.0}
    assert read(record, []) is None
    # the store of this process, empty
    assert read(record) is None
    # a program without spans
    import mpgan_torch
    monkeypatch.delattr(mpgan_torch, "tracing")
    monkeypatch.setitem(sys.modules, "mpgan_torch.tracing", None)
    assert sp.load() is None
    assert read(record) is None


def test_gap_is_the_mean_over_cards():
    rows = [_span("train.replay", 0.01, (0, 0, 5)),
            _span("train.replay", 0.01, (0, 7, 9)),
            _span("train.replay", 0.01, (1, 0, 5)),
            _span("train.replay", 0.01, (1, 5, 9))]
    read = manifest.reader("train.replay_gap_pct")
    assert read({"units": 2, "window_s": 0.01}, rows) == pytest.approx(10.0)


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_cuda_capture_records_nothing_and_a_replay_has_an_interval():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x = torch.ones(1 << 20, device=dev)

    def fn():
        with tracing.span("t.captured", dev):
            return (x * 2).sum()
    with tracing.enable():
        g = graphed.Graph(fn, dev)
        assert [s["name"] for s in tracing.spans()] == ["graph.capture"]
        for _ in range(3):
            with tracing.span("t.replay", dev):
                g.replay()
    rows = [s for s in tracing.spans() if s["name"] == "t.replay"]
    assert len(rows) == 3
    for a, b in zip(rows, rows[1:]):
        assert a["device"] == dev.index or a["device"] == 0
        assert 0 <= a["device_start_ms"] < a["device_end_ms"] \
            <= b["device_start_ms"]
    assert float(g.out) == 2 * (1 << 20)
