"""The solver's step and the datagen frame as CUDA graphs
(mpgan_torch.solver.graphed ``GraphedStep``, mpgan_torch.solver.datagen),
and the slice-split upscaler graphed per card (mpgan_torch.train.graphed
``CardPrograms``), on the CPU with the capture primitive replaced by
tests/_torch_graph_stub.py's ``StubGraph``, and on cards (marked
``cuda``; skipped without them).

The stub's capture runs nothing (a capture records draws without making
them), and each replay after the first writes into the outputs the first
returned, as a CUDA graph writes its static outputs: a caller that kept a
replay's output would see it overwritten. Its log notes each capture's
device.

- ``GraphedStep`` over 3 steps (3D Jacobi and CG with an obstacle, a
  moving obstacle, no inflow, 2D; 16³ and 32²) equals the eager step bit
  for bit at every step, and each step equals JAX's jitted ``smoke.step``
  / ``smoke2d.step`` on the same input within 1e-5
  (tests/test_torch_solver.py's tolerance for a whole step).
- A registered generator reseeded with ``noise.frame_seed`` draws, through
  the capture and its replays, what ``noise.frame_generator`` draws.
- ``generate_sim`` (a plume with an obstacle, a drawn moving scene, JAX's
  injected moving scene and inflow) and ``generate_sim_2d``, graphed
  through the stub, write byte-identical files to the eager runs (the
  clock fixed for both).
- Over two and three "cards" (``cpu:i``, distinct devices to the port),
  the graphed upscaler, ``precompute_finals`` and a pipeline stage over
  two cards equal their eager runs bit for bit, each card's programs
  captured on it; a program's static inputs keep their inputs' strides;
  without the copy-out a device list that repeats a card gives wrong
  frames.
- On cards: the same comparisons with CUDA graphs, bit for bit (one card
  for the solver, two and three for the upscaler and the pipeline).
  These import no JAX.
"""

import os
import time

import numpy as np
import pytest
import torch

from _torch_graph_stub import install
from mpgan_torch.infer import assemble as TA
from mpgan_torch.infer import pipeline as TPP
from mpgan_torch.models import generator as TG
from mpgan_torch.solver import datagen as tdatagen
from mpgan_torch.solver import graphed as tgraphed
from mpgan_torch.solver import noise as tnoise
from mpgan_torch.solver import smoke as tsmoke
from mpgan_torch.solver import smoke2d as tsmoke2d
from mpgan_torch.train import graphed

torch.set_num_threads(1)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

STEP_ATOL = 1e-5   # a whole step against JAX (tests/test_torch_solver.py)
N = 16             # 3D fields; 2D fields are 2N
STEPS = 3


def _count(log, what):
    return sum(1 for entry in log if entry[0] == what)


def _device(graph, event):
    return (graph.device,)


@pytest.fixture
def stub(monkeypatch):
    return install(monkeypatch, _device)


# ------------------------------------------------------------------ step


def _case(name):
    """(state class, the port's step, JAX's step, state arrays, params,
    per-step (solid, inflow density, inflow mask)), from a numpy seed."""
    from mpgan_tpu.solver import smoke as jsmoke
    from mpgan_tpu.solver import smoke2d as jsmoke2d

    rng = np.random.default_rng(len(name))
    solver = "cg" if name == "cg" else "jacobi"
    params = tsmoke.SmokeParams(dt=0.5, buoyancy=2e-2, vorticity_eps=0.1,
                                jacobi_iters=30, cg_iters=30,
                                maccormack=True, pressure_solver=solver)
    if name == "2d":
        n = 2 * N
        shape = (n, n)
        solid = np.array(jsmoke2d.disc_mask(n, n, (0.55, 0.5), 0.15))
        mask = np.array(jsmoke2d.disc_mask(n, n, (0.12, 0.5), 0.12))
        fields = (tsmoke2d.Smoke2DState, tsmoke2d.step, jsmoke2d.step,
                  jsmoke2d.Smoke2DState, 2)
    else:
        shape = (N, N, N)
        solid = np.array(jsmoke.sphere_mask(N, N, N, (0.5, 0.5, 0.5), 0.2))
        mask = np.array(jsmoke.sphere_mask(N, N, N, (0.5, 0.12, 0.5), 0.2))
        fields = (tsmoke.SmokeState, tsmoke.step, jsmoke.step,
                  jsmoke.SmokeState, 3)
    cls, step, jstep, jcls, channels = fields
    dens = rng.random(shape + (1,), dtype=np.float32)
    vel = (rng.standard_normal(shape + (channels,)) * 0.5).astype(np.float32)
    if name == "moving":
        orbit = tdatagen.Orbit(N, 0.5, 0.5, 0.15, 0.2, 0.3, 6.0)
        solids = [orbit(t).numpy() for t in range(STEPS)]
    else:
        solids = [solid] * STEPS
    per_step = []
    for s in solids:
        src = rng.random(mask.shape, dtype=np.float32)
        m = mask * (1 - s)
        per_step.append((s, None, None) if name == "no_inflow"
                        else (s, src, m))
    state = (dens * (1 - solids[0]), vel * (1 - solids[0]), solids[0])
    return cls, step, jstep, jcls, state, params, per_step


@pytest.mark.parametrize("name", ["jacobi", "cg", "moving", "no_inflow",
                                  "2d"])
def test_graphed_step_equals_eager_and_jax(stub, name):
    import jax.numpy as jnp
    from mpgan_tpu.solver import smoke as jsmoke

    cls, step, jstep, jcls, arrays, params, per_step = _case(name)
    jparams = jsmoke.SmokeParams(**params.__dict__)
    T = torch.from_numpy
    eager = cls(*map(T, arrays))
    state = cls(*(T(a.copy()) for a in arrays))
    graphed_step = tgraphed.GraphedStep(step)
    for k, (solid, src, mask) in enumerate(per_step):
        src, mask = (None if a is None else T(a) for a in (src, mask))
        before = [t.clone() for t in state]
        eager = step(eager._replace(solid=T(solid)), params, src, mask)
        state = graphed_step(state._replace(solid=T(solid)), params, src,
                             mask)
        for g, e in zip(state, eager):
            assert torch.equal(g, e), (name, k)
        want = jstep(jcls(*(jnp.asarray(t.numpy()) for t in
                            before[:2] + [T(solid)])), jparams,
                     None if src is None else jnp.asarray(src.numpy()),
                     None if mask is None else jnp.asarray(mask.numpy()))
        for g, w in zip(state, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=STEP_ATOL, err_msg=f"{name} {k}")
    # step 0 eager, step 1 captured and replayed, step 2 replayed; one
    # program per (shape, params, inflow given)
    assert [e[0] for e in stub.log] == ["capture", "replay", "replay"]
    (key,) = graphed_step.programs
    assert key[2] == params and key[3] == (name != "no_inflow")
    graphed_step.release()
    assert stub.log[-1][0] == "reset" and not graphed_step.programs


def test_graphed_step_keys_and_overwrites(stub):
    """A second params value gets its own program; a replay overwrites
    what the last one returned."""
    cls, step, _, _, arrays, params, per_step = _case("jacobi")
    state = cls(*map(torch.from_numpy, arrays))
    solid, src, mask = (torch.from_numpy(a) for a in per_step[0])
    graphed_step = tgraphed.GraphedStep()
    outs = [graphed_step(state, params, src, mask) for _ in range(3)]
    assert outs[1].density is outs[2].density
    other = params.__class__(**{**params.__dict__, "jacobi_iters": 10})
    graphed_step(state, other, src, mask)
    assert len(graphed_step.programs) == 2
    assert torch.equal(outs[0].density,
                       step(state, params, src, mask).density)


def test_graphed_step_refuses_the_cpu():
    cls, _, _, _, arrays, params, per_step = _case("jacobi")
    state = cls(*map(torch.from_numpy, arrays))
    with pytest.raises(ValueError, match="CUDA card"):
        tgraphed.GraphedStep()(state, params)


def test_reseeded_generator_draws_what_frame_generator_draws(stub):
    gen = torch.Generator()
    program = graphed.GraphedProgram(
        lambda: tnoise.value_noise_3d((N, N, N), gen), (), "cpu", gen)
    for t in range(4):      # eager, capture + replay, replays
        gen.manual_seed(tnoise.frame_seed(5, t))
        got = program().clone()
        want = tnoise.value_noise_3d((N, N, N),
                                     tnoise.frame_generator(5, t, "cpu"))
        assert torch.equal(got, want), t
    assert [e[0] for e in stub.log] == ["capture", "replay", "replay",
                                        "replay"]


# ------------------------------------------------------------------ datagen


@pytest.fixture
def fixed_clock(monkeypatch):
    """The wall clock stopped: a .uni header's timestamp and gzip's mtime
    are equal in two runs."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n
    return names


def _jax_moving(seed):
    """JAX's drawn moving scene as an injected port Scene (its solid_at a
    function, not an Orbit) and JAX's inflow of step t."""
    import jax
    import jax.numpy as jnp
    from mpgan_tpu.solver import datagen as jdatagen
    from mpgan_tpu.solver import noise as jnoise

    key = jax.random.PRNGKey(seed)
    state, inflow, params, strength, solid_at = \
        jdatagen.varied_plume_scene(key, N, "moving")

    def t(x):
        return torch.from_numpy(np.array(x))
    sc = tdatagen.Scene(tsmoke.SmokeState(*map(t, state)), t(inflow),
                        tsmoke.SmokeParams(**params.__dict__), strength,
                        lambda step: t(solid_at(jnp.float32(step))))
    return sc, lambda step: t(jnoise.time_varying_inflow(
        key, inflow, step, strength=strength))


@pytest.mark.parametrize("scene", ["plume", "moving", "injected", "2d"])
def test_graphed_datagen_writes_the_eager_files(tmp_path, fixed_clock,
                                                monkeypatch, scene):
    def run(out):
        kw = dict(warmup=2, device="cpu")
        if scene == "2d":
            return tdatagen.generate_sim_2d(out, 3, 2 * N, 2, 3,
                                            with_obstacle=True, **kw)
        if scene == "injected":
            sc, inflow_at = _jax_moving(7)
            return tdatagen.generate_sim(out, 7, N, 2, 3, save_flags=True,
                                         injected=sc, inflow_at=inflow_at,
                                         **kw)
        return tdatagen.generate_sim(out, 3, N, 2, 3,
                                     with_obstacle=scene == "plume",
                                     save_flags=True, scene=scene, **kw)
    eager = run(str(tmp_path / "eager"))
    stub = install(monkeypatch, _device)
    got = run(str(tmp_path / "graphed"))
    assert not eager["graphed"] and got["graphed"]
    names = _same_files(str(tmp_path / "eager"), str(tmp_path / "graphed"))
    assert len(names) == (4 if scene == "2d" else 5) * 3
    log = [e[0] for e in stub.log]
    # frame_step: 5 steps, captured at the second; frame_outputs: 3
    # frames, captured at the second; both released at the end
    assert log.count("capture") == 2 and log.count("replay") == 4 + 2
    assert log[-2:] == ["reset", "reset"]


def test_moving_orbit_masks_match_the_scene():
    mv = tdatagen.make_scene(4, 24, "moving")
    orbit = mv.solid_at
    assert isinstance(orbit, tdatagen.Orbit)
    assert torch.equal(mv.state.solid, orbit(0))
    cx = torch.tensor(orbit.cx(10), dtype=torch.float32)
    assert torch.equal(orbit.mask(cx), orbit(10))
    assert not torch.equal(orbit(0), orbit(10))


# ------------------------------------------------------------------ cards


def _chain(seed=0):
    torch.manual_seed(seed)
    return TG.make_pass1(2, 8, 1).eval(), TG.make_pass2(2, 8, 1).eval()


def _cpu_cards(k):
    return [torch.device("cpu", i) for i in range(k)]


def _frames(n, shape=(6, 8, 8, 4), seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random(shape, dtype=np.float32))
            for _ in range(n)]


@pytest.mark.parametrize("k", [2, 3])
def test_upscaler_over_cards_equals_eager(stub, k):
    g1, g2 = _chain()
    cards = _cpu_cards(k)
    upscale = TA.make_graphed_upscaler(g1, g2, 4, devices=cards)
    assert upscale.programs.split
    frames = _frames(4)
    got = [upscale(f) for f in frames]
    # per card one program per pass: the first frame eager, the second
    # captured and replayed, the rest replayed
    assert _count(stub.log, "capture") == 2 * k
    assert _count(stub.log, "replay") == 3 * 2 * k
    (programs,) = upscale.programs.values()
    assert {key[2] for key in programs} == set(cards)
    assert all(p.graph.device == key[2] for key, p in programs.items())
    assert len({g.data_ptr() for g in got}) == len(got)
    for f, g in zip(frames, got):
        with torch.inference_mode():
            want = TA.upscale_volume(g1, g2, f, 4, devices=cards)
        assert torch.equal(g, want)
    # a sweep over the cards replays too, and releases its programs
    vols = torch.stack(_frames(3, seed=4))
    stub.log.clear()
    got = TA.precompute_finals(g1, g2, vols, 4, devices=cards)
    assert _count(stub.log, "capture") == 2 * k
    assert _count(stub.log, "reset") == 2 * k
    for v, g in zip(vols, got):
        with torch.inference_mode():
            assert torch.equal(g, TA.upscale_volume(g1, g2, v, 4,
                                                    devices=cards).float())


def test_static_inputs_keep_the_input_strides(stub):
    """The first card's share is a strided view of the slice stack, and
    cuDNN picks a convolution's kernels by its input's layout: a
    program's static input keeps its input's strides (a contiguous copy
    made graphed shares differ from eager ones on four cards)."""
    stack = torch.arange(96.0).reshape(4, 3, 4, 2).permute(1, 0, 2, 3)
    share = torch.tensor_split(stack, 3)[0]
    assert not share.is_contiguous()
    program = graphed.GraphedProgram(lambda y: y * 2, (), "cpu")
    got = [program(share).clone() for _ in range(3)]
    assert program.captured and program.xs[0].stride() == share.stride()
    assert all(torch.equal(g, share * 2) for g in got)


def test_missing_copy_out_fails_on_a_repeated_card(stub, monkeypatch):
    """A list that repeats a card replays one program for two of its
    shares before the gather: without the copy-out the first share's
    slices are the second's."""
    g1, g2 = _chain()
    cards = _cpu_cards(2) * 2
    frames = _frames(3, shape=(8, 8, 8, 4), seed=5)
    with torch.inference_mode():
        want = [TA.upscale_volume(g1, g2, f, 4, devices=cards)
                for f in frames]
    upscale = TA.make_graphed_upscaler(g1, g2, 4, devices=cards)
    assert all(torch.equal(upscale(f), w) for f, w in zip(frames, want))
    monkeypatch.setattr(graphed, "run_copied",
                        lambda program, *xs: program(*xs))
    upscale = TA.make_graphed_upscaler(g1, g2, 4, devices=cards)
    got = [upscale(f) for f in frames]
    assert torch.equal(got[0], want[0])          # eager
    assert not torch.equal(got[2], want[2])


def test_pipeline_stage_over_cards_equals_eager(stub):
    g1, g2 = _chain(1)
    cards = _cpu_cards(3)
    pp = TPP.InferencePipeline(g1, g2, 4, devices=cards, split=(1, 2))
    assert [(st.graphed, st.programs.split)
            for st in pp.stages] == [(True, False), (True, True)]
    frames = [f.numpy() for f in _frames(4, shape=(8, 8, 8, 4), seed=6)]
    got = list(pp.stream(frames))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphed, "graphable",
                   lambda device, devices=None: False)
        eager = TPP.InferencePipeline(g1, g2, 4, devices=cards, split=(1, 2))
    want = list(eager.stream(frames))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (programs,) = pp.stages[1].programs.values()
    assert isinstance(programs, graphed.CardPrograms)
    assert {key[2] for key in programs} == set(cards[1:])
    pp.release()
    assert not any(st.programs for st in pp.stages)


# ------------------------------------------------------------------ on cards


def _need_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card{'s' * (n > 1)}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["jacobi", "cg", "2d"])
def test_cuda_graphed_step_equals_eager_bit_for_bit(name):
    _need_cards(1)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 32
    shape = (n, n) if name == "2d" else (n, n, n)
    mod = tsmoke2d if name == "2d" else tsmoke
    mask = (tsmoke2d.disc_mask(n, n, (0.12, 0.5), 0.12, dev)
            if name == "2d" else
            tsmoke.sphere_mask(n, n, n, (0.5, 0.12, 0.5), 0.14, dev))
    solid = (tsmoke2d.disc_mask(n, n, (0.55, 0.5), 0.1, dev) if name == "2d"
             else tsmoke.sphere_mask(n, n, n, (0.5, 0.55, 0.5), 0.12, dev))
    params = tsmoke.SmokeParams(jacobi_iters=50, cg_iters=60,
                                pressure_solver="cg" if name == "cg"
                                else "jacobi")
    cls = tsmoke2d.Smoke2DState if name == "2d" else tsmoke.SmokeState
    dens = torch.from_numpy(rng.random(shape + (1,), dtype=np.float32))
    vel = torch.from_numpy((rng.standard_normal(
        shape + (len(shape),)) * 0.5).astype(np.float32))
    eager = cls(dens.to(dev) * (1 - solid), vel.to(dev) * (1 - solid), solid)
    state = cls(*(t.clone() for t in eager))
    graphed_step = tgraphed.GraphedStep(mod.step)
    for k in range(4):
        src = torch.rand(solid.shape, device=dev)
        eager = mod.step(eager, params, src, mask)
        state = graphed_step(state, params, src, mask)
        for g, e in zip(state, eager):
            assert torch.equal(g, e), (name, k)
    (program,) = graphed_step.programs.values()
    assert program.captured
    graphed_step.release()


@pytest.mark.cuda
def test_cuda_reseeded_generator_draws_what_frame_generator_draws():
    _need_cards(1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    program = graphed.GraphedProgram(
        lambda: tnoise.value_noise_3d((32, 32, 32), gen), (), dev, gen)
    for t in range(4):
        gen.manual_seed(tnoise.frame_seed(5, t))
        got = program().clone()
        want = tnoise.value_noise_3d((32, 32, 32),
                                     tnoise.frame_generator(5, t, dev))
        assert torch.equal(got, want), t
    assert program.captured
    program.release()


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["plume", "moving", "2d"])
def test_cuda_graphed_datagen_writes_the_eager_files(tmp_path, fixed_clock,
                                                     monkeypatch, scene):
    _need_cards(1)

    def run(out):
        if scene == "2d":
            return tdatagen.generate_sim_2d(out, 3, 64, 4, 3, warmup=2,
                                            with_obstacle=True)
        return tdatagen.generate_sim(out, 3, 32, 4, 3, warmup=2,
                                     with_obstacle=scene == "plume",
                                     save_flags=True, scene=scene)
    got = run(str(tmp_path / "graphed"))
    monkeypatch.setattr(graphed, "graphable",
                        lambda device, devices=None: False)
    eager = run(str(tmp_path / "eager"))
    assert got["graphed"] and not eager["graphed"]
    _same_files(str(tmp_path / "eager"), str(tmp_path / "graphed"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3])
def test_cuda_upscaler_over_distinct_cards_equals_eager(monkeypatch, k):
    """The graphed upscaler and a pipeline stage over ``k`` cards, each
    card's shares captured on it, equal eager runs over the same cards bit
    for bit under cuDNN's deterministic mode."""
    _need_cards(k)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cards = [torch.device("cuda", i) for i in range(k)]
    torch.manual_seed(0)
    g1 = TG.make_pass1(2, 16, 2).to(cards[0]).eval()
    g2 = TG.make_pass2(2, 16, 2).to(cards[0]).eval()
    frames = [f.to(cards[0]) for f in _frames(5, shape=(16, 16, 16, 4))]
    upscale = TA.make_graphed_upscaler(g1, g2, 4, devices=cards)
    got = [upscale(f) for f in frames]
    (programs,) = upscale.programs.values()
    assert {key[2] for key in programs} == set(cards)
    assert all(p.captured for p in programs.values())
    pp = TPP.InferencePipeline(g1, g2, 4, devices=[cards[0]] + cards,
                               split=(1, k))
    assert pp.stages[1].programs.split
    piped = list(pp.stream([f.cpu().numpy() for f in frames]))
    for d in cards:
        torch.cuda.synchronize(d)
    for f, g, p in zip(frames, got, piped):
        with torch.inference_mode():
            want = TA.upscale_volume(g1, g2, f, 4, devices=cards)
        assert torch.equal(g, want)
        assert torch.equal(p, want.to(p.device))
    pp.release()
    upscale.programs.popitem()[1].release()


@pytest.mark.cuda
def test_cuda_served_upscaler_over_every_card(monkeypatch):
    """serve.make_upscaler over every visible card (two or more) replays
    each card's shares: its responses equal eager upscale_volume calls
    over the same cards bit for bit."""
    _need_cards(2)
    from mpgan_torch import serve
    from mpgan_torch.parallel import mesh as pmesh

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    torch.manual_seed(0)
    dev = torch.device("cuda", 0)
    g1 = TG.make_pass1(2, 16, 2).to(dev).eval()
    g2 = TG.make_pass2(2, 16, 2).to(dev).eval()
    upscale = serve.make_upscaler((g1, g2, None), dev)
    frames = [f.numpy() for f in _frames(4, shape=(16, 16, 16, 4))]
    got = [upscale(f) for f in frames]
    cards = pmesh.make_mesh()
    for f, g in zip(frames, got):
        with torch.inference_mode():
            want = TA.upscale_volume(g1, g2, torch.from_numpy(f).to(dev), 4,
                                     devices=cards)
        assert torch.equal(g, want)
