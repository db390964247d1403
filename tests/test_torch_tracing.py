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
  through the graphed programs (the capture primitive stubbed), a pass-1
  and a pass-2 step's D-run, G-run and batches among them, and a
  graphed upscaler split over ``cpu:0..2`` as distinct cards, whose every
  pass enqueues all its scatters before any share.
- Each reader of ``port_bench/metrics/`` over a synthetic span list with a
  known answer, and None on an empty list or where the program has no
  spans.
- Captured spans, with the card's events and capture stood in for: the
  last traced replay's read by ``spans()``, nested and timed as captured,
  under the span open at their replay; an untraced replay forgets the one
  before.
- On a card (marked ``cuda``; skipped without one): a span inside a CUDA
  graph capture stores nothing, and a replay's span has a device
  interval; a captured three-pass upscaler's replays time each pass. No
  JAX is imported here, so on a card's machine ``python -m
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

from _torch_graph_stub import install, small_config, tile_creator
from mpgan_torch import tracing
from mpgan_torch.infer import assemble
from mpgan_torch.models import generator as TG
from mpgan_torch.train import graphed, losses
from mpgan_torch.train import loop as tloop
from port_bench import manifest
from port_bench import spans as sp

torch.set_num_threads(1)

READERS = ("upscaler.host_ms_per_frame", "upscaler.share_ms_per_frame",
           "upscaler.card0_only_ms_per_frame", "train.replay_gap_pct",
           "train.launch_us_per_step", "upscaler.pass3_ms_per_frame",
           "upscaler.pass3_roofline", "train.sample_ms_per_step",
           "train.d_run_ms_per_step")


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


def _split_upscaler(monkeypatch, k=3):
    install(monkeypatch)
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
    tr = tloop.Trainer(small_config(), tile_creator(), device="cpu")
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
    tr = tloop.Trainer(small_config(), tile_creator(), device="cpu")
    with tracing.enable():
        tr.fit(2, log_every=2)
    rows = tracing.spans()
    steps = [s for s in rows if s["name"] == "train.step"]
    assert [s["attrs"]["it"] for s in steps] == [0, 1]
    tree = Counter(_tree(rows))
    # a step is a D-run and a G-run, each assembling a batch; a D-run
    # aligns the fake and real triplets, the G-run the fake one
    assert tree == Counter({("train.step", None): 2,
                            ("train.eager", "train.step"): 2,
                            ("train.d_run", "train.eager"): 2,
                            ("train.g_run", "train.eager"): 2,
                            ("train.sample", "train.d_run"): 2,
                            ("train.sample", "train.g_run"): 2,
                            ("warp.align", "train.d_run"): 4,
                            ("warp.align", "train.g_run"): 2,
                            ("train.read_metrics", "train.step"): 1})
    assert all(s["attrs"]["it"] in (0, 1) for s in rows)


def test_trainer_spans_through_the_graphed_programs(monkeypatch):
    install(monkeypatch)
    tr = tloop.Trainer(small_config(), tile_creator(), device="cpu",
                       graphs=True)
    with tracing.enable():
        tr.fit(4, log_every=4)
    tree = Counter(_tree(tracing.spans()))
    # step 0 is the first use of the program with R1, step 1 of the one
    # without, which step 2 captures and replays and step 3 replays
    assert tree[("train.eager", "train.step")] == 2
    assert tree[("train.replay", "train.step")] == 2
    assert tree[("train.read_metrics", "train.step")] == 1


@pytest.mark.parametrize("pass_no", [1, 2])
def test_a_captured_step_spans_its_runs_and_batches(monkeypatch, pass_no):
    """Through the graphed programs, eager at each program's first use and
    replayed after: every step of pass 1 and of pass 2 is one
    ``train.d_run`` and one ``train.g_run``, each the parent of one
    ``train.sample``; a replayed step's rows carry its program's ``r1``
    and the step's ``it``."""
    install(monkeypatch)
    tr = tloop.Trainer(small_config(), tile_creator(), device="cpu",
                       pass_no=pass_no, graphs=True)
    with tracing.enable():
        tr.fit(4, log_every=4)
    rows = tracing.spans()
    tree = Counter(_tree(rows))
    assert tree[("train.eager", "train.step")] == 2
    assert tree[("train.replay", "train.step")] == 2
    for run in ("train.d_run", "train.g_run"):
        assert tree[(run, "train.eager")] == 2
        assert tree[(run, "train.replay")] == 2
        assert tree[("train.sample", run)] == 4
    assert sum(n for (name, _), n in tree.items()
               if name == "train.sample") == 8
    replayed = [s for s in rows if s["name"] == "train.sample"
                and "r1" in s["attrs"]]
    assert sorted((s["attrs"]["it"], s["attrs"]["r1"]) for s in replayed) \
        == [(2, False)] * 2 + [(3, False)] * 2


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


def test_split_upscaler_scatters_every_share_before_any_share_runs(
        monkeypatch):
    # a copy between cards runs on the first card's stream behind what is
    # queued there: a scatter after the first card's share holds the rest
    up, frame = _split_upscaler(monkeypatch, k=3)
    for _ in range(2):
        up(frame)
    with tracing.enable():
        up(frame)
    rows = tracing.spans()
    for p in (1, 2):
        scatters = [s for s in rows if s["name"] == "upscale.scatter"
                    and s["attrs"]["pass_no"] == p]
        shares = [s for s in rows if s["name"] == "upscale.share"
                  and s["attrs"]["pass_no"] == p]
        assert len(scatters) == len(shares) == 3
        assert max(s["host_end_ns"] for s in scatters) \
            <= min(s["host_start_ns"] for s in shares)


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
    # two frames' pass 3 of 10 and 30 device ms; pass 2 and an untimed
    # pass 3 left out
    "upscaler.pass3_ms_per_frame": (
        [_span("upscale.pass", 1, (0, 0, 10), {"pass_no": 3}),
         _span("upscale.pass", 1, (0, 20, 50), {"pass_no": 3}),
         _span("upscale.pass", 1, (0, 10, 20), {"pass_no": 2}),
         _span("upscale.pass", 1, None, {"pass_no": 3})],
        {"units": 2, "window_s": 1.0}, 20.0),
    # the same spans: a least time of 5 ms a frame (the operations' bound
    # over the bytes' 1 ms) against 20 ms a frame
    "upscaler.pass3_roofline": (
        [_span("upscale.pass", 1, (0, 0, 10), {"pass_no": 3}),
         _span("upscale.pass", 1, (0, 20, 50), {"pass_no": 3}),
         _span("upscale.pass", 1, (0, 10, 20), {"pass_no": 2}),
         _span("upscale.pass", 1, None, {"pass_no": 3})],
        {"units": 2, "window_s": 1.0, "pass3_flops_per_unit": 989e12 * 5e-3,
         "pass3_bytes_per_unit": 3.35e12 * 1e-3}, 25.0),
    # three replays of the program without R1 and one with it: the last
    # traced replay of each read, its batches 1 + 1.5 ms and 2 + 1 ms; the
    # untimed one left out
    "train.sample_ms_per_step": (
        [_span("train.replay", 0.01, (0, 0, 5), {"it": i, "r1": i == 0})
         for i in range(4)]
        + [_span("train.sample", 1, (0, 0, 1), {"it": 3, "r1": False}),
           _span("train.sample", 1, (0, 3, 4.5), {"it": 3, "r1": False}),
           _span("train.sample", 1, (0, 10, 12), {"it": 0, "r1": True}),
           _span("train.sample", 1, (0, 15, 16), {"it": 0, "r1": True}),
           _span("train.sample", 1, None, {"it": 3, "r1": False})],
        {"units": 4, "window_s": 1.0}, (3 * 2.5 + 3.0) / 4),
    # the same replays: D-runs of 4 ms without R1 and 8 ms with it
    "train.d_run_ms_per_step": (
        [_span("train.replay", 0.01, (0, 0, 5), {"it": i, "r1": i == 0})
         for i in range(4)]
        + [_span("train.d_run", 1, (0, 0, 4), {"it": 3, "r1": False}),
           _span("train.d_run", 1, (0, 10, 18), {"it": 0, "r1": True}),
           _span("train.g_run", 1, (0, 4, 9), {"it": 3, "r1": False})],
        {"units": 4, "window_s": 1.0}, (3 * 4.0 + 8.0) / 4),
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


# ------------------------------------------------------- captured spans


class _FakeEvent:
    """A timing event on a counter that each record advances."""
    clock = 0

    def __init__(self):
        self.t = None

    def record(self):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.t - self.t)


class _FakeCapture:
    """A graph captured with ``tracing.capture()`` whose replay records the
    captured events again in capture order, as the card does."""

    def __init__(self, fn, capturing):
        with tracing.capture() as self.spans:
            capturing["on"] = True
            try:
                fn()
            finally:
                capturing["on"] = False
        self.order = sorted((ev for row in self.spans.rows
                             for ev in row[4:6]), key=lambda e: e.t)

    def replay(self):
        with tracing.replay(self.spans):
            for ev in self.order:
                ev.record()


def test_the_last_traced_replay_s_captured_spans_are_read_at_spans(
        monkeypatch):
    """With the card's events and capture stood in for: a capture stores
    nothing; a traced replay's captured spans enter the store at the next
    ``spans()`` unless a later replay came first (which records their
    events anew, so only the last is read and no replay waits), under the
    span open when their replay began, with their capture-time nesting and
    attributes and device intervals inside it, in order; an untraced
    replay forgets the one before it."""
    capturing = {"on": False}
    dev = torch.device("cuda", 0)

    def event(device, external=False):
        ev = _FakeEvent()
        ev.record()
        return ev
    monkeypatch.setattr(tracing, "_event", event)
    monkeypatch.setattr(tracing, "_capturing", lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def fn():
        for p in (1, 2, 3):
            with tracing.span("upscale.pass", dev, pass_no=p):
                with tracing.span("inner", dev, k=p):
                    pass
            with tracing.span("untimed"):
                pass
    g = _FakeCapture(fn, capturing)
    assert [r[:3] for r in g.spans.rows] == [
        ["upscale.pass", {"pass_no": 1}, None],
        ["inner", {"pass_no": 1, "k": 1}, 0],
        ["upscale.pass", {"pass_no": 2}, None],
        ["inner", {"pass_no": 2, "k": 2}, 2],
        ["upscale.pass", {"pass_no": 3}, None],
        ["inner", {"pass_no": 3, "k": 3}, 4]]
    assert tracing.spans() == []
    g.replay()
    with tracing.enable():
        g.replay()
    g.replay()
    assert tracing.spans() == []
    with tracing.enable():
        for i in range(3):
            with tracing.span("upscale.frame", dev, i=i):
                g.replay()
        rows = tracing.spans()
        for i in range(3, 5):
            with tracing.span("upscale.frame", dev, i=i):
                g.replay()
            rows = tracing.spans()
    frames = [s for s in rows if s["name"] == "upscale.frame"]
    assert [s["attrs"]["i"] for s in frames] == [0, 1, 2, 3, 4]
    by_id = {s["id"]: s for s in rows}
    for frame in frames:
        mine = [s for s in rows if s["parent"] == frame["id"]]
        if frame["attrs"]["i"] < 2:
            assert mine == []
            continue
        assert [s["attrs"]["pass_no"] for s in mine] == [1, 2, 3]
        assert all(s["attrs"]["i"] == frame["attrs"]["i"] for s in mine)
        for a, b in zip(mine, mine[1:]):
            assert a["device_end_ms"] <= b["device_start_ms"]
        assert frame["device_start_ms"] <= mine[0]["device_start_ms"] \
            and mine[-1]["device_end_ms"] <= frame["device_end_ms"]
        for s in mine:
            (inner,) = [c for c in rows if c["parent"] == s["id"]]
            assert inner["name"] == "inner"
            assert by_id[inner["parent"]] is s
            assert s["device_start_ms"] < inner["device_start_ms"] \
                < inner["device_end_ms"] < s["device_end_ms"]
            assert s["host_start_ns"] >= frame["host_start_ns"]
    assert len(rows) == 5 + 3 * 6
    # read once: a second call adds nothing
    assert len(tracing.spans()) == len(rows)


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


@pytest.mark.cuda
def test_cuda_replays_of_a_captured_three_pass_upscaler_time_each_pass():
    """A three-pass upscaler captured on the card (64³ → 256³ bf16, G3 at
    its published widths): under ``tracing.enable()`` each replay read by
    ``spans()`` gives three ``upscale.pass`` rows, ordered, inside the
    frame's device interval and summing to within 2% of it (the frame adds
    the copies in and out and the graph's launch); a replay followed by
    another before ``spans()`` gives none; the capture stores none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    g1, g2 = (make(2, 32, 2, dtype=torch.bfloat16, out_dtype=torch.bfloat16)
              for make in (TG.make_pass1, TG.make_pass2))
    g3 = TG.make_pass3(32, 2, dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    g1, g2, g3 = (g.to(dev).eval().requires_grad_(False)
                  for g in (g1, g2, g3))
    up = assemble.make_graphed_upscaler(g1, g2, 4, gen3=g3)
    frame = torch.rand((64, 64, 64, 4), device=dev)
    for _ in range(2):
        up(frame)
    assert tracing.spans() == []
    with tracing.enable():
        for _ in range(2):
            up(frame)
        rows = tracing.spans()
        for _ in range(3):
            up(frame)
            rows = tracing.spans()
    assert "graph.capture" not in {s["name"] for s in rows}
    frames = [s for s in rows if s["name"] == "upscale.frame"]
    assert len(frames) == 5
    assert [s for s in rows if s["parent"] == frames[0]["id"]] == []
    for frame_row in frames[1:]:
        passes = [s for s in rows if s["parent"] == frame_row["id"]]
        assert [(s["name"], s["attrs"]["pass_no"]) for s in passes] == [
            ("upscale.pass", 1), ("upscale.pass", 2), ("upscale.pass", 3)]
        assert all(s["device"] == frame_row["device"] for s in passes)
        assert frame_row["device_start_ms"] <= passes[0]["device_start_ms"]
        for a, b in zip(passes, passes[1:]):
            assert a["device_start_ms"] < a["device_end_ms"] \
                <= b["device_start_ms"]
        assert passes[-1]["device_end_ms"] <= frame_row["device_end_ms"]
        total = sum(sp.device_ms(s) for s in passes)
        assert total == pytest.approx(sp.device_ms(frame_row), rel=0.02)
