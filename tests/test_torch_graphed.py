"""The graphed train step (mpgan_torch.train.graphed) on the CPU, where the
capture primitive is replaced by tests/_torch_graph_stub.py's
``StubGraph``, which records its calls (with the program's R1 flag and,
at a replay, the generator's seed) and runs the captured function at each
replay, and on a card (marked ``cuda``; skipped without one).

- Three steps at stage 2 with fade through the runtime's programs,
  alpha 0.3, 0.5 and 0.7 in the programs' fade-weight tensors, the step
  counter from 15 (R1 at step 16 only), against one K=3 ``lax.scan``
  dispatch of the JAX runtime's ``step_fade`` on the same injected batch
  (CPU, float32, TF32 off), at tests/test_torch_train_step.py's recipe
  (learning rates and Adam's ε of 1). Its tolerances (metrics rtol 1e-4,
  parameters atol 1e-5) hold one step; three need metrics rtol 5e-4 and
  parameters atol 2e-3, because at a learning rate of 1 each step moves
  every parameter by up to 1: the losses reach 1e5 by step 2 and the
  feature loss 1e14 by step 3, and the float32 gap of one step (2.4e-6 in
  G) grows with them, to 7.2e-4 in Ds (parameters up to 2) and a relative
  1.9e-4 in the feature loss, measured on the CPU. A wrong fade weight or
  R1 choice moves parameters by a large fraction of 1.
- The dispatch rule over a ``useGrowing`` schedule with ``r1Interval`` 4:
  which program each iteration runs, eager at a program's first use,
  captured at its second, each iteration's seed, the step counter, the
  graphs released at a growth boundary and at a restore; and when
  ``Trainer`` replays graphs at all.
- Inside a process group of one (gloo, as tests/test_torch_parallel.py):
  a gloo rank steps eagerly and refuses ``graphs=True``; with the backend
  reported as NCCL, the rank runs the dispatch rule over the growth
  schedule, each replay runs the step's four all-reduces (three updates
  and the metrics), each step's program follows from the step counter
  alone (so ranks that share it pick alike), and the run equals the
  eager rank bit for bit.
- The program layer itself, through the stub: a :class:`ProgramCache`'s
  program per key, its eviction beyond ``MAX_PROGRAMS`` with release, a
  new replica's new program and its split over distinct cards; and a
  launch counter a kernel wrapper registers (``tracing.count_launches``)
  put back after a capture and added at each replay (the CUDA primitives
  stubbed).
- On a card: replay against eager stepping, bit for bit in float32 under
  cuDNN's deterministic mode, over a growth boundary with fade and R1,
  alone and as the rank of an NCCL group of one; the warp launch counts;
  and ``remat`` under capture. The JAX package is
  imported only inside the test that compares with it, so that on a
  card's machine, which has no JAX, ``python -m pytest --noconftest -p
  no:cacheprovider tests/test_torch_graphed.py -m cuda`` runs the rest.
"""

import contextlib
import sys
import types

import numpy as np
import pytest
import torch

from _torch_graph_stub import StubGraph, install
from _torch_graph_stub import small_config as _config
from _torch_graph_stub import tile_creator as _tc
from mpgan_torch import tracing
from mpgan_torch.ops import warp_kernel
from mpgan_torch.parallel import mesh as pmesh
from mpgan_torch.train import graphed
from mpgan_torch.train import loop as tloop

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# three steps at a learning rate of 1 (module docstring)
K3_METRIC_RTOL = 5e-4
K3_PARAM_ATOL = 2e-3


def _r1_and_seed(graph, event):
    """A log entry's detail: the capturing program's R1 flag and, at a
    replay, the generator's seed."""
    r1 = graph.fn.__self__.r1
    if event == "replay":
        return r1, graph.generator.initial_seed()
    return (r1,)


@pytest.fixture
def stub(monkeypatch):
    return install(monkeypatch, _r1_and_seed)


def test_k3_fade_steps_match_jax_scan(monkeypatch, stub):
    import jax
    import jax.numpy as jnp
    from mpgan_tpu.train import loop as jloop
    from test_torch_train_step import (METRICS, _sd, injected_pair,
                                       small_config)

    cfg = small_config()
    batch, jtr, jrt, ttr = injected_pair(monkeypatch, cfg)
    alphas = [0.3, 0.5, 0.7]
    # the step donates its state and EMA: hand it copies
    state = jloop.copy_tree(jrt.state)._replace(step=jnp.int32(15))
    ema = jloop.copy_tree(jrt.ema)
    state, ema, jm = jrt.step_fade(state, ema, jtr._data(),
                                   jax.random.PRNGKey(1),
                                   jnp.asarray(alphas, jnp.float32))

    rt = ttr.rt
    rt.step = 15
    rt.step_fade.sample = lambda rng: batch
    programs = graphed.Programs(rt, torch.Generator())
    for a in alphas:
        tm = tloop.read_metrics(programs(True, a))
    # steps 15 and 17 run the program without R1 (eagerly, then captured
    # and replayed), step 16 the one with R1
    assert [k for k in programs.programs] == [(True, False), (True, True)]
    assert [e[0] for e in stub.log] == ["capture", "replay"]
    assert programs.programs[(True, False)].alpha.item() == 0.7
    assert rt.step == 18
    for k in METRICS:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=K3_METRIC_RTOL,
                                   atol=1e-6, err_msg=k)
    for what, got, want in (("G", rt.gen.state_dict(), state.params_g),
                            ("Ds", rt.ds.state_dict(), state.params_ds),
                            ("Dt", rt.dt.state_dict(), state.params_dt),
                            ("EMA", rt.ema, ema)):
        want = _sd(want)
        assert set(got) == set(want), what
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       want[k].numpy(), rtol=0,
                                       atol=K3_PARAM_ATOL,
                                       err_msg=f"{what} {k}")


def _growing_config():
    # stage 1 for iterations 0-7; stage 2 fades over 8-11 (alpha 0, 0.25,
    # 0.5, 0.75) and is stable from 12; R1 at steps 0, 4, 8, 12
    cfg = _config(use_growing=True, alpha_iters=4, stable_iters=4)
    cfg.loss.r1_interval = 4
    return cfg


def test_dispatch_rule_over_a_growth_schedule(monkeypatch, stub, tmp_path):
    cfg = _growing_config()
    tr = tloop.Trainer(cfg, _tc(), device="cpu", graphs=True)
    calls = []
    run = tloop.TrainStep.run

    def recorded(self, alpha, rng, r1):
        a = float(alpha) if self.fade else None
        calls.append((self.rt.stage, self.fade, r1, a, rng.initial_seed(),
                      self.rt.step))
        return run(self, alpha, rng, r1)

    monkeypatch.setattr(tloop.TrainStep, "run", recorded)
    tr.fit(16, log_every=16)
    assert tr.rt.step == 16

    # (stage, fade, R1) of each iteration, the fade weight it saw, its seed
    # and the step counter while it ran
    want = []
    for it in range(16):
        stage = 1 if it < 8 else 2
        fade = 8 <= it < 12
        want.append((stage, fade, it % 4 == 0,
                     (it - 8) / 4 if fade else None,
                     tloop._step_seed(cfg.train.rand_seed, it), it))
    assert calls == want
    assert len({c[4] for c in calls}) == 16

    # a program's first use is eager, its second captures; every later use
    # replays; the growth boundary releases stage 1's two graphs
    seeds = [c[4] for c in calls]
    log = [e[:2] + ((seeds.index(e[2]),) if e[0] == "replay" else ())
           for e in stub.log]
    assert log == [
        ("capture", False), ("replay", False, 2), ("replay", False, 3),
        ("capture", True), ("replay", True, 4),
        ("replay", False, 5), ("replay", False, 6), ("replay", False, 7),
        ("reset", True), ("reset", False),
        ("capture", False), ("replay", False, 10), ("replay", False, 11),
        ("capture", False), ("replay", False, 14), ("replay", False, 15)]
    assert [k for k in tr.programs.programs] == [
        (True, True), (True, False), (False, True), (False, False)]

    # a restore builds a new runtime: the old one's graphs are released
    stub.log.clear()
    tr.save(str(tmp_path), 0, 16)
    old = tr.programs
    assert tr.restore(str(tmp_path), 0) == 16
    assert stub.log == [("reset", False), ("reset", False)]
    assert old.programs == {} and tr.programs is not old
    assert tr.programs.rt is tr.rt and tr.rt.step == 16


def test_when_the_trainer_replays_graphs(monkeypatch, capsys):
    tc = _tc()
    assert tloop.Trainer(_config(), tc, device="cpu").graphs is False
    with pytest.raises(ValueError, match="no CUDA graphs on cpu"):
        tloop.Trainer(_config(), tc, device="cpu", graphs=True)
    eager = tloop.Trainer(_config(), tc, device="cpu", graphs=False)
    assert eager.graphs is False and eager.fit(2)["steps_per_dispatch"] == 1
    assert eager.programs is None
    # where graphs exist: on by default, off with debugNans (said once)
    monkeypatch.setattr(graphed.Graph, "available",
                        staticmethod(lambda device: True))
    assert tloop.Trainer(_config(), tc, device="cpu").graphs is True
    capsys.readouterr()
    tr = tloop.Trainer(_config(debug_nans=True), tc, device="cpu")
    assert tr.graphs is False
    assert capsys.readouterr().out.count("steps eagerly") == 1
    with pytest.raises(ValueError, match="debugNans"):
        tloop.Trainer(_config(debug_nans=True), tc, device="cpu",
                      graphs=True)


@pytest.fixture
def group(tmp_path):
    """This process as the only rank of a gloo group (a FileStore)."""
    pmesh.init_distributed("file://" + str(tmp_path / "store"), 1, 0,
                           "gloo")
    try:
        yield
    finally:
        pmesh.shutdown()


def test_a_gloo_rank_steps_eagerly(group, monkeypatch):
    monkeypatch.setattr(graphed.Graph, "available",
                        staticmethod(lambda device: True))
    tc = _tc()
    assert tloop.Trainer(_config(), tc, device="cpu").graphs is False
    with pytest.raises(ValueError, match="gloo process group"):
        tloop.Trainer(_config(), tc, device="cpu", graphs=True)


def test_an_nccl_rank_replays_its_collectives(group, monkeypatch, stub):
    """The rank's dispatch over 16 iterations of the growth schedule (the
    log of test_dispatch_rule_over_a_growth_schedule), the all-reduces
    inside each replay, and the state against the eager rank's."""
    tc = _tc()
    eager = tloop.Trainer(_growing_config(), tc, device="cpu", graphs=False)
    eager.fit(16, log_every=16)
    monkeypatch.setattr(pmesh, "backend", lambda: "nccl")
    tr = tloop.Trainer(_growing_config(), tc, device="cpu")
    assert tr.graphs is True
    reduces, per_replay, picked = [0], [], []
    all_reduce = torch.distributed.all_reduce

    def counted(*a, **k):
        reduces[0] += 1
        return all_reduce(*a, **k)

    stub_replay = StubGraph.replay

    def replay(self):
        n = reduces[0]
        out = stub_replay(self)
        per_replay.append(reduces[0] - n)
        return out

    call = graphed.Programs.__call__

    def recorded(self, fade, alpha):
        picked.append((self.rt.step, fade, self.rt.step_stable.r1_due()))
        return call(self, fade, alpha)

    monkeypatch.setattr(torch.distributed, "all_reduce", counted)
    monkeypatch.setattr(StubGraph, "replay", replay)
    monkeypatch.setattr(graphed.Programs, "__call__", recorded)
    tr.fit(16, log_every=16)
    assert [e[:2] for e in stub.log] == [
        ("capture", False), ("replay", False), ("replay", False),
        ("capture", True), ("replay", True),
        ("replay", False), ("replay", False), ("replay", False),
        ("reset", True), ("reset", False),
        ("capture", False), ("replay", False), ("replay", False),
        ("capture", False), ("replay", False), ("replay", False)]
    # Ds, Dt and G's gradients and the metrics: one flat buffer each
    assert per_replay == [4] * 10
    # the program of each step is a function of the step counter and the
    # schedule, which every rank shares
    assert picked == [(it, 8 <= it < 12, it % 4 == 0) for it in range(16)]
    got, want = _params(tr), _params(eager)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------- the program layer


def test_program_cache_keys_evicts_and_follows_the_replica(monkeypatch):
    """One program per key, eager at its first use, captured at its second
    and replayed after, each replay's output copied out; beyond
    ``MAX_PROGRAMS`` the least recently used key's program is released; a
    call over another module (a new replica) releases its key's program
    and starts a new one; over distinct cards the call runs with its key's
    ``CardPrograms``."""
    stub = install(monkeypatch)
    x = torch.ones(3, 2)
    old, new = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)

    def fn(module):
        return lambda y, programs=None: module(y)
    cache = graphed.ProgramCache("cpu")
    assert not cache.split and cache.limit == graphed.MAX_PROGRAMS == 2
    with torch.no_grad():
        outs = [cache.run("a", fn(old), (old,), x) for _ in range(3)]
        assert stub.log == ["capture", "replay", "replay"]
        assert outs[1] is not outs[2] and torch.equal(outs[2], old(x))
        first = cache["a"]
        for key in ("b", "b", "a", "c"):
            cache.run(key, fn(old), (old,), x)
        # b was used less recently than a: released and dropped
        assert list(cache) == ["a", "c"] and stub.log[-1] == "reset"
        assert cache["a"] is first and first.captured
        got = cache.run("a", fn(new), (new,), x)
        assert not first.captured and stub.log.count("reset") == 2
        assert cache["a"].modules == (new,) and cache["a"].uses == 1
        assert torch.equal(got, new(x))
        cards = [torch.device("cpu", i) for i in range(2)]
        split = graphed.ProgramCache("cpu", cards)
        seen = []
        split.run("a", lambda y, programs=None: seen.append(programs),
                  (old,), x)
    assert split.split and seen == [split["a"]]
    assert isinstance(seen[0], graphed.CardPrograms)
    assert seen[0].modules == (old,) and seen[0].limit is None


def test_a_registered_counter_is_put_back_and_added_at_replays(monkeypatch):
    """A kernel wrapper's launch counter, registered by name in
    ``tracing.COUNTERS``: a capture that launched through it leaves it as
    it was, each replay adds the capture's launches, and the warp pair is
    ``Graph.launches``. The CUDA primitives are stubbed."""
    fake = types.ModuleType("fake_kernel")
    fake.launches = 5
    fake.up_launches = 2
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    monkeypatch.setattr(tracing, "COUNTERS", dict(tracing.COUNTERS))
    # two counters of one module, as conv_kernel's conv and conv_up
    tracing.count_launches(fake.__name__, fake="launches",
                           fake_up="up_launches")

    class CUDAGraph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", CUDAGraph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, **kw: contextlib.nullcontext())
    monkeypatch.setattr(warp_kernel, "bwd_launches", 7)

    def fn():
        fake.launches += 3
        fake.up_launches += 1
        warp_kernel.bwd_launches += 1
    g = graphed.Graph(fn, torch.device("cuda", 0))
    assert (fake.launches, fake.up_launches,
            warp_kernel.bwd_launches) == (5, 2, 7)
    assert g.counts == {"fake": 3, "fake_up": 1, "warp_bwd": 1}
    assert g.launches == (0, 1)
    g.replay()
    g.replay()
    assert (fake.launches, fake.up_launches,
            warp_kernel.bwd_launches) == (11, 4, 9)


# ------------------------------------------------------------------ card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _deterministic(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)


STEP_METRICS = ("d_loss", "dt_loss", "g_loss", "g_adv", "l1", "feat",
                "g_t", "psnr")


def _params(tr):
    rt = tr.rt
    out = {f"{n}.{k}": v.detach().clone()
           for n in ("gen", "ds", "dt")
           for k, v in getattr(rt, n).state_dict().items()}
    out.update({f"ema.{k}": v.clone() for k, v in rt.ema.items()})
    for name in ("opt_g", "opt_ds", "opt_dt"):
        for i, st in getattr(rt, name).state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v.clone() for k, v in st.items()})
    return out


@pytest.mark.cuda
def test_cuda_replay_equals_eager_bit_for_bit(monkeypatch):
    """20 steps over a growth boundary with fade, R1 every 4 steps, in
    float32 under cuDNN's deterministic mode: the graphed run's nets, EMA,
    optimizer moments and last metrics equal the eager run's bits, and both
    launch 3 forward and 1 backward warp kernels per step."""
    dev = _cuda()
    _deterministic(monkeypatch)
    tc = _tc(dev)
    runs = {}
    for graphs in (False, True):
        tr = tloop.Trainer(_growing_config(), tc, device=dev, graphs=graphs)
        n0 = (warp_kernel.launches, warp_kernel.bwd_launches)
        out = tr.fit(20, log_every=20)
        torch.cuda.synchronize()
        assert (warp_kernel.launches - n0[0],
                warp_kernel.bwd_launches - n0[1]) == (60, 20)
        runs[graphs] = (out, _params(tr), tr)
    (m0, p0, _), (m1, p1, tr) = runs[False], runs[True]
    # the fade program with R1 ran once (step 8), eagerly; every other
    # program of stage 2 was captured and replayed
    assert [k for k, p in tr.programs.programs.items()
            if p.graph is None] == [(True, True)]
    assert ({k: m1[k] for k in STEP_METRICS}
            == {k: m0[k] for k in STEP_METRICS})
    assert p1.keys() == p0.keys()
    for k in p0:
        assert torch.equal(p1[k], p0[k]), k


@pytest.mark.cuda
def test_cuda_remat_is_captured(monkeypatch):
    """``remat`` (activation checkpointing of the generator's blocks)
    under capture: 6 graphed steps equal 6 eager ones bit for bit."""
    dev = _cuda()
    _deterministic(monkeypatch)
    tc = _tc(dev)
    got = []
    for graphs in (False, True):
        cfg = _config()
        cfg.model.remat = True
        cfg.loss.r1_interval = 4
        tr = tloop.Trainer(cfg, tc, device=dev, graphs=graphs)
        tr.fit(6, log_every=6)
        got.append(_params(tr))
    for k in got[0]:
        assert torch.equal(got[1][k], got[0][k]), k


@pytest.mark.cuda
def test_cuda_nccl_rank_replay_equals_eager_bit_for_bit(monkeypatch,
                                                         tmp_path):
    """As test_cuda_replay_equals_eager_bit_for_bit, as the only rank of
    an NCCL group: the graphs hold the rank's all-reduces."""
    dev = _cuda()
    _deterministic(monkeypatch)
    tc = _tc(dev)
    pmesh.init_distributed("file://" + str(tmp_path / "store"), 1, 0, "nccl")
    try:
        runs = {}
        for graphs in (False, True):
            # the default replays in an NCCL group
            tr = tloop.Trainer(_growing_config(), tc, device=dev,
                               graphs=None if graphs else False)
            assert tr.graphs is graphs
            out = tr.fit(20, log_every=20)
            torch.cuda.synchronize()
            runs[graphs] = (out, _params(tr))
    finally:
        pmesh.shutdown()
    (m0, p0), (m1, p1) = runs[False], runs[True]
    assert ({k: m1[k] for k in STEP_METRICS}
            == {k: m0[k] for k in STEP_METRICS})
    for k in p0:
        assert torch.equal(p1[k], p0[k]), k
