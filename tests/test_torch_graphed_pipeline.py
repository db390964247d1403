"""The pipeline's stages as CUDA graphs (mpgan_torch.infer.pipeline) on
the CPU, where the capture primitive is replaced by
``AliasingGraph`` (tests/test_torch_graphed_infer.py: a replay writes
into the captured outputs, so a frame handed over without a copy would be
overwritten by the stage's next replay), and on a card (marked ``cuda``;
skipped without one).

- A two-stage and a three-stage stream of 6 frames (base 8, one res
  block, 4x, float32) with every stage graphed: every frame, read after
  all are out, equals the eager pipeline's bit for bit and JAX's
  ``InferencePipeline`` within 1e-5 (as tests/test_torch_pipeline_parallel.py).
- Each stage captures on its own device, and ``graphed.Graph`` captures
  on a stream of the card it is given with that card current, whichever
  card an earlier capture used (the CUDA primitives stubbed).
- The graphing rule: a stage whose group is one device (repeated or not)
  graphs its whole pass, a stage over distinct devices each card's share.
- A generator changed in place on another device gets a new replica, and
  the stage a new program.
- On a card: graphed frames equal eager ones bit for bit, float32 and
  bf16, under cuDNN's deterministic mode; with two or three cards, one
  stage on each card, each graphed on its own card. These tests import
  no JAX.

The eager pipeline is built while ``assemble.graphable`` answers False.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from mpgan_torch.infer import assemble as TA
from mpgan_torch.infer import pipeline as TPP
from mpgan_torch.models import generator as TG
from mpgan_torch.train import graphed
from test_torch_graphed_infer import AliasingGraph

torch.set_num_threads(1)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-5  # tests/test_torch_pipeline_parallel.py
CPU = torch.device("cpu")


@pytest.fixture
def stub(monkeypatch):
    AliasingGraph.log = []
    monkeypatch.setattr(graphed, "Graph", AliasingGraph)
    return AliasingGraph


def _eager(*args, **kwargs):
    """An InferencePipeline with no stage graphed."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TA, "graphable", lambda device, devices=None: False)
        pp = TPP.InferencePipeline(*args, **kwargs)
    assert not any(st.graphed for st in pp.stages)
    return pp


def _frames(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.random((8, 8, 8, 4), dtype=np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def streams():
    """The gens of tests/test_torch_pipeline_parallel.py (flax-initialised,
    converted) and JAX's pipelines' volumes for 6 frames, 2 and 3 stages,
    each stage jitted once."""
    import jax
    import jax.numpy as jnp
    from mpgan_torch import convert
    from mpgan_tpu.infer import pipeline as JPP
    from mpgan_tpu.models import generator as JG

    g1 = JG.make_pass1(2, base_filters=8, n_res_blocks=1)
    g2 = JG.make_pass2(2, base_filters=8, n_res_blocks=1)
    g3 = JG.make_pass3(base_filters=8, n_res_blocks=1)
    p1 = g1.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    p2 = g2.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 32, 4)))
    p3 = g3.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 4)))
    ported = []
    for t, p in ((TG.make_pass1(2, 8, 1), p1), (TG.make_pass2(2, 8, 1), p2),
                 (TG.make_pass3(8, 1), p3)):
        t.load_state_dict(convert.flax_to_state_dict(
            jax.tree.map(np.asarray, p)))
        ported.append(t.eval())
    frames = _frames(6)
    want = {2: [np.asarray(o) for o in JPP.InferencePipeline(
                g1, p1, g2, p2, up_res=4).stream(frames)],
            3: [np.asarray(o) for o in JPP.InferencePipeline(
                g1, p1, g2, p2, up_res=4, gen3=g3, params3=p3).stream(
                    frames)]}
    return ported, frames, want


@pytest.mark.parametrize("n_stages", [2, 3])
def test_graphed_stages_equal_eager_and_jax(stub, streams, n_stages):
    (t1, t2, t3), frames, want = streams
    gen3 = t3 if n_stages == 3 else None
    devices = [CPU] * n_stages
    pp = TPP.InferencePipeline(t1, t2, 4, devices=devices, gen3=gen3)
    assert pp.split == (1,) * n_stages
    assert all(st.graphed for st in pp.stages)
    got = list(pp.stream(frames))
    # per stage: frame 0 eager, frame 1 captured and replayed, 2-5 replayed
    assert stub.log.count("capture") == n_stages
    assert stub.log.count("replay") == 5 * n_stages
    assert all(p.captured and p.graph.device == st.device
               for st in pp.stages for p in st.programs.values())
    ref = list(_eager(t1, t2, 4, devices=devices, gen3=gen3).stream(frames))
    assert stub.log.count("replay") == 5 * n_stages   # eager: no replay
    assert len({g.data_ptr() for g in got}) == len(got) == 6
    for g, r, w in zip(got, ref, want[n_stages]):
        assert g.shape == w.shape == (32, 32, 32, 1)
        assert torch.equal(g, r)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    pp.release()
    assert stub.log.count("reset") == n_stages
    assert not any(st.programs for st in pp.stages)


def test_stage_graphing_rule(monkeypatch):
    """A stage over one device, repeated or not, replays its whole pass as
    one graph; a stage over distinct devices (default_split(4, 2, 4) =
    (1, 3)) replays each card's share (``split``)."""
    monkeypatch.setattr(graphed.Graph, "available",
                        staticmethod(lambda device: True))
    # the stages' streams are never used here
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: object())
    g1, g2 = TG.make_pass1(2, 8, 1).eval(), TG.make_pass2(2, 8, 1).eval()
    cards = [torch.device("cuda", i) for i in range(4)]
    pp = TPP.InferencePipeline(g1, g2, 4, devices=cards)
    assert pp.split == (1, 3)
    assert [st.graphed for st in pp.stages] == [True, True]
    assert [st.split for st in pp.stages] == [False, True]
    pp = TPP.InferencePipeline(g1, g2, 4, devices=[cards[0]] * 4)
    assert [st.graphed for st in pp.stages] == [True, True]
    assert [st.split for st in pp.stages] == [False, False]
    pp = TPP.InferencePipeline(g1, g2, 4, devices=cards[:2])
    assert pp.split == (1, 1)
    assert [st.device for st in pp.stages] == cards[:2]
    assert [st.graphed for st in pp.stages] == [True, True]


def test_graph_captures_on_its_own_card(monkeypatch):
    """``graphed.Graph`` captures on a stream of the card it is given, with
    that card current while the captured function runs, also after a
    capture on another card: torch.cuda.graph's own side stream lives on
    the card of the process's first capture, where a later stage's work on
    another card would not be captured. The CUDA primitives are stubbed to
    record the capture stream's card and the current card. The cyclic
    garbage collector is off while the captured function runs (a
    collection could reset a dropped graph mid-capture) and on after."""
    current = [torch.device("cuda", 0)]
    seen = []

    class Stream:
        def __init__(self, device=None):
            self.device = current[0] if device is None else torch.device(
                device)

    @contextlib.contextmanager
    def device(d):
        prev, current[0] = current[0], torch.device(d)
        try:
            yield
        finally:
            current[0] = prev

    class Capture:
        def __init__(self, graph, pool=None, stream=None,
                     capture_error_mode="global"):
            self.stream = stream

        def __enter__(self):
            seen.append({"stream": getattr(self.stream, "device", None),
                         "current": current[0]})

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    cards = [torch.device("cuda", i) for i in (0, 1, 0)]
    def fn():
        seen[-1].update(fn=current[0], gc=gc.isenabled())
    assert gc.isenabled()
    for card in cards:
        graphed.Graph(fn, card)
    assert seen == [{"stream": c, "current": c, "fn": c, "gc": False}
                    for c in cards]
    assert current[0] == torch.device("cuda", 0) and gc.isenabled()


def test_a_new_replica_gets_a_new_program(stub, monkeypatch):
    """The generators live elsewhere than the stages (here: replicas forced
    by a patched device check): a change in place makes a new replica, and
    the stage drops the program that captured the old one."""
    torch.manual_seed(0)
    g1, g2 = TG.make_pass1(2, 8, 1).eval(), TG.make_pass2(2, 8, 1).eval()
    pp = TPP.InferencePipeline(g1, g2, 4, devices=[CPU] * 2)
    replicas = {}

    def replica(gen, device):
        version = tuple(p._version for p in gen.parameters())
        key = (id(gen), version)
        if key not in replicas:
            replicas[key] = TA.copy.deepcopy(gen)
        return replicas[key]
    monkeypatch.setattr(TA, "replica", replica)
    frames = _frames(3, seed=4)
    list(pp.stream(frames))
    first = pp.stages[0].programs[((tuple(frames[0].shape),
                                    torch.float32),)]
    assert first.captured
    with torch.no_grad():
        for p in g1.parameters():
            p.mul_(0.5)
    got = list(pp.stream(frames[:1]))
    # the old program released, the new replica's program used eagerly
    assert first.graph is None and stub.log.count("reset") == 1
    (program,) = pp.stages[0].programs.values()
    assert program is not first and program.uses == 1
    with torch.inference_mode():
        want = TA.upscale_volume(g1, g2, torch.from_numpy(frames[0]), 4)
    assert torch.equal(got[0], want)


# ------------------------------------------------------------------ card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_stages", [2, 3])
def test_cuda_graphed_stages_equal_eager_bit_for_bit(monkeypatch, dtype,
                                                     n_stages):
    """6 frames through a graphed and an eager pipeline on one card, under
    cuDNN's deterministic mode, read after all are out: equal bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    dev = torch.device("cuda")
    torch.manual_seed(0)
    g1 = TG.make_pass1(2, 16, 2, dtype=dtype).to(dev).eval()
    g2 = TG.make_pass2(2, 16, 2, dtype=dtype).to(dev).eval()
    g3 = (TG.make_pass3(16, 2, dtype=dtype).to(dev).eval()
          if n_stages == 3 else None)
    frames = _frames(6, seed=5)
    pp = TPP.InferencePipeline(g1, g2, 4, devices=[dev] * n_stages, gen3=g3)
    got = list(pp.stream(frames))
    assert all(p.captured for st in pp.stages for p in st.programs.values())
    want = list(_eager(g1, g2, 4, devices=[dev] * n_stages,
                       gen3=g3).stream(frames))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_capture_survives_a_dropped_graph():
    """A graph left in a reference cycle (as a dropped pipeline leaves its
    stages' graphs) is not collected during a later capture, whose
    function allocates enough to trigger automatic collections: a reset
    there would invalidate the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    x = torch.arange(8.0, device=dev)

    def drop():
        cycle = [graphed.Graph(lambda: x * 2, dev)]
        cycle.append(cycle)
    drop()

    def fn():
        [[] for _ in range(20000)]
        return x + 1
    g = graphed.Graph(fn, dev)
    assert torch.equal(g.replay(), x + 1)
    g.reset()
    gc.collect()


@pytest.mark.cuda
@pytest.mark.parametrize("n_stages", [2, 3])
def test_cuda_stages_on_distinct_cards_equal_eager_bit_for_bit(monkeypatch,
                                                               n_stages):
    """One stage on each of ``n_stages`` cards, each graphed on its own
    card: 6 float32 frames, read after all are out, equal an eager
    pipeline's over the same cards bit for bit under cuDNN's deterministic
    mode, and a one-card upscale_volume's within 1e-5."""
    if torch.cuda.device_count() < n_stages:
        pytest.skip(f"needs {n_stages} CUDA cards")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cards = [torch.device("cuda", i) for i in range(n_stages)]
    torch.manual_seed(0)
    g1 = TG.make_pass1(2, 16, 2).to(cards[0]).eval()
    g2 = TG.make_pass2(2, 16, 2).to(cards[0]).eval()
    g3 = TG.make_pass3(16, 2).to(cards[0]).eval() if n_stages == 3 else None
    frames = _frames(6, seed=6)
    pp = TPP.InferencePipeline(g1, g2, 4, devices=cards, gen3=g3)
    assert pp.split == (1,) * n_stages
    assert [st.device for st in pp.stages] == cards
    assert all(st.graphed for st in pp.stages)
    got = list(pp.stream(frames))
    assert all(p.captured for st in pp.stages for p in st.programs.values())
    want = list(_eager(g1, g2, 4, devices=cards, gen3=g3).stream(frames))
    for d in cards:
        torch.cuda.synchronize(d)
    for f, g, w in zip(frames, got, want):
        assert g.device == cards[-1]
        assert torch.equal(g, w)
        with torch.inference_mode():
            one = TA.upscale_volume(g1, g2, torch.from_numpy(f).to(cards[0]),
                                    4, gen3=g3)
        assert float((g.to(cards[0]) - one).abs().max()) <= ATOL
