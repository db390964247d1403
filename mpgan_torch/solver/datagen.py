"""Training-data generation: buoyant smoke scenes → LR/HR ``.uni`` pairs —
counterpart of ``mpgan_tpu/solver/datagen.py``.

Per simulation, an HR plume (optionally with solid obstacles) is stepped on
the device, and each frame writes ``density_high_%04d.uni`` /
``velocity_high_%04d.uni`` plus the blurred and downsampled
``density_low_%04d.uni`` / ``velocity_low_%04d.uni`` into
``<base>/sim_%04d/``; the LR fields are always the HR ones downsampled,
never simulated apart. Writes go through :mod:`mpgan_torch.io.uni` (gzip
level 1, atomic, plain TypeVec3 velocities, mantaflow flag values).

Per simulation two device programs run, as JAX jits them
(``mpgan_tpu/solver/datagen.py:158-172``, the 2D ones ``:235-247``):
``frame_step`` (the inflow noise and the solver step) and
``frame_outputs`` (the downsampled LR fields). On a card each is a CUDA
graph (:class:`~mpgan_torch.infer.assemble.GraphedProgram`: eager at its
first use, captured at its second, replayed after; released at the sim's
end), elsewhere the same functions run eagerly; both ways write the same
bytes. The moving obstacle's mask is built inside ``frame_step`` from its
centre, a 0-d input filled per frame (:class:`Orbit`).

Random draws: a scene's parameters come from a CPU ``torch.Generator``
seeded with the sim's seed (``randSeed + sim``), each frame's inflow noise
from one generator on the device per sim, reseeded before each frame with
(seed, frame index) (:func:`mpgan_torch.solver.noise.frame_seed`) and
registered with the graph, so that a replay draws what an eager frame
draws. JAX's threefry stream is not reproduced: one seed gives a
different scene in each package, drawn from the same distribution.
:func:`generate_sim` takes an injected scene and per-frame inflow so that
a test can feed it the JAX package's draws.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from mpgan_torch.device import resolve_device
from mpgan_torch.infer import assemble
from mpgan_torch.io import uni
from mpgan_torch.ops.resample import downsample_2d, downsample_3d
from mpgan_torch.solver import noise, smoke, smoke2d
from mpgan_torch.utils.liveness import touch_heartbeat

SCENES = ("plume", "varied", "varied-dual", "moving")


class Scene(NamedTuple):
    """A simulation's set-up: the initial state, the inflow mask, the
    solver parameters, the inflow strength and, for the moving family,
    ``solid_at(t)`` → the (Z, Y, X, 1) obstacle mask of step t (an
    :class:`Orbit`, or any function, such as a test's injected masks)."""
    state: smoke.SmokeState
    inflow: torch.Tensor
    params: smoke.SmokeParams
    strength: float = 1.0
    solid_at: Callable[[int], torch.Tensor] | None = None


@dataclass(frozen=True)
class Orbit:
    """The moving family's obstacle: a sphere of radius ``r`` centred at
    (cz, cy, cx(t)) of the domain, cx(t) = 0.5 + amp·sin(2π t / period +
    phase). ``orbit(t)`` → the (Z, Y, X, 1) mask of step t on ``device``."""
    res: int
    cz: float
    cy: float
    r: float
    amp: float
    phase: float
    period: float
    device: torch.device | None = None

    def cx(self, t: int) -> float:
        """The centre's x at step t, in float32 on the host as the JAX
        package traces it."""
        t32 = torch.tensor(float(t), dtype=torch.float32)
        return float(0.5 + self.amp * torch.sin(
            2.0 * math.pi * t32 / self.period + self.phase))

    def mask(self, cx: torch.Tensor) -> torch.Tensor:
        """The mask about the centre x ``cx``, a 0-d float32 tensor (a
        graphed frame's static input), on ``cx``'s device."""
        return smoke.sphere_mask(self.res, self.res, self.res,
                                 (self.cz, self.cy, cx), self.r, cx.device)

    def __call__(self, t: int) -> torch.Tensor:
        return self.mask(torch.tensor(self.cx(t), dtype=torch.float32,
                                      device=self.device))


def _uniform(gen: torch.Generator, lo: float, hi: float) -> float:
    return lo + (hi - lo) * float(torch.rand((), generator=gen,
                                             dtype=torch.float64))


def plume_scene(gen: torch.Generator, res: int, with_obstacle: bool = False,
                pressure_solver: str = "jacobi", device=None) -> Scene:
    """A rising plume from a sphere near the bottom (y is up), with a
    sphere obstacle above it at a drawn height when asked."""
    solid = None
    if with_obstacle:
        cy = _uniform(gen, 0.45, 0.65)
        solid = smoke.sphere_mask(res, res, res, (0.5, cy, 0.5), 0.12,
                                  device)
    state = smoke.init_state(res, res, res, solid, device)
    inflow = smoke.sphere_mask(res, res, res, (0.5, 0.12, 0.5), 0.14, device)
    if solid is not None:
        inflow = inflow * (1.0 - solid)
    params = smoke.SmokeParams(dt=0.5, buoyancy=2e-2, vorticity_eps=0.1,
                               jacobi_iters=50, maccormack=True,
                               pressure_solver=pressure_solver)
    return Scene(state, inflow, params)


def varied_plume_scene(gen: torch.Generator, res: int, scene: str = "varied",
                       pressure_solver: str = "jacobi", device=None) -> Scene:
    """The randomised scene families: inflow position, radius and strength,
    buoyancy, vorticity confinement and the obstacles are drawn per sim.

      varied       randomised plume + 0–2 static sphere obstacles
      varied-dual  two randomised inflow spheres merging mid-domain
      moving       randomised plume + one obstacle orbiting through it
                   (``solid_at`` is set)
    """
    solid = torch.zeros((res, res, res, 1), device=device)
    solid_at = None
    if scene == "moving":
        ob_cy = _uniform(gen, 0.40, 0.60)
        ob_r = _uniform(gen, 0.07, 0.12)
        ob_cz = _uniform(gen, 0.40, 0.60)
        amp = _uniform(gen, 0.14, 0.22)
        phase = _uniform(gen, 0.0, 6.28)
        period = _uniform(gen, 30.0, 60.0)
        solid_at = Orbit(res, ob_cz, ob_cy, ob_r, amp, phase, period, device)
        solid = solid_at(0)
    else:
        n_obs = int(torch.randint(0, 3, (), generator=gen))
        for _ in range(n_obs):
            c = (_uniform(gen, 0.25, 0.75), _uniform(gen, 0.35, 0.70),
                 _uniform(gen, 0.25, 0.75))
            solid = torch.maximum(solid, smoke.sphere_mask(
                res, res, res, c, _uniform(gen, 0.06, 0.13), device))
    cx = _uniform(gen, 0.35, 0.65)
    cz = _uniform(gen, 0.35, 0.65)
    inflow = smoke.sphere_mask(res, res, res, (cz, 0.12, cx),
                               _uniform(gen, 0.10, 0.17), device)
    if scene == "varied-dual":
        cx2 = _uniform(gen, 0.25, 0.75)
        cz2 = _uniform(gen, 0.25, 0.75)
        inflow = torch.maximum(inflow, smoke.sphere_mask(
            res, res, res, (cz2, 0.12, cx2), _uniform(gen, 0.08, 0.14),
            device))
    inflow = inflow * (1.0 - solid)
    params = smoke.SmokeParams(
        dt=0.5, buoyancy=_uniform(gen, 0.012, 0.030),
        vorticity_eps=_uniform(gen, 0.05, 0.20), jacobi_iters=50,
        maccormack=True, pressure_solver=pressure_solver)
    strength = _uniform(gen, 0.7, 1.3)
    return Scene(smoke.init_state(res, res, res, solid), inflow, params,
                 strength, solid_at)


def make_scene(seed: int, res: int, scene: str = "plume",
               with_obstacle: bool = False, pressure_solver: str = "jacobi",
               device=None) -> Scene:
    """The scene of one sim, its draws from a CPU generator seeded with
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if scene == "plume":
        return plume_scene(gen, res, with_obstacle, pressure_solver, device)
    return varied_plume_scene(gen, res, scene, pressure_solver, device)


def _frame_progress(f: int) -> None:
    """Per-frame liveness and fault injection for the ``retryOnError``
    supervisor of :mod:`mpgan_torch.datagen`: touch the heartbeat after
    every written frame; ``MPGAN_FAIL_ONCE`` raises after the first frame
    unless its sentinel exists (the protocol of the port's train loop)."""
    touch_heartbeat()
    fail_once = os.environ.get("MPGAN_FAIL_ONCE")
    if fail_once and not os.path.exists(fail_once):
        with open(fail_once, "w") as fh:
            fh.write(f"injected after frame {f}\n")
        raise RuntimeError(f"MPGAN_FAIL_ONCE: injected fault after frame {f}")


class _FrameClock:
    """Split of a written frame: device time of its step and downsample
    (CUDA events; None on the CPU), the wall time until the device is done,
    and the host time to fetch and write the files."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device_ms, self.compute_s, self.write_s = [], [], []

    def start(self):
        self.t0 = time.perf_counter()
        if self.cuda:
            self.ev = [torch.cuda.Event(enable_timing=True) for _ in (0, 1)]
            self.ev[0].record()

    def computed(self):
        if self.cuda:
            self.ev[1].record()
            torch.cuda.synchronize()
            self.device_ms.append(self.ev[0].elapsed_time(self.ev[1]))
        self.t1 = time.perf_counter()
        self.compute_s.append(self.t1 - self.t0)

    def written(self):
        self.write_s.append(time.perf_counter() - self.t1)

    def stats(self, steps: int, seconds: float) -> dict:
        n = max(len(self.compute_s), 1)
        return {"frames": len(self.compute_s), "steps": steps,
                "seconds": seconds, "steps_per_s": steps / seconds,
                "frame_device_ms": (sum(self.device_ms) / n
                                    if self.cuda else None),
                "frame_compute_ms": 1e3 * sum(self.compute_s) / n,
                "frame_fetch_write_ms": 1e3 * sum(self.write_s) / n}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


class Frames:
    """A sim's two device programs, ``frame_step`` and ``frame_outputs``
    (module docstring). ``advance(state, t)`` → the state after frame
    ``t`` (the inflow noise, the moving obstacle and the solver step);
    ``outputs(state)`` → the LR density and velocity. ``step_fn(*inputs)``
    → the new state's fields, where ``inputs(state, t)`` are its inputs
    for frame t and its noise is drawn from ``generator``;
    ``outputs_fn(density, velocity)`` → the LR fields. On a card each is a
    :class:`~mpgan_torch.infer.assemble.GraphedProgram`, ``generator``
    registered with the step's (``graphed``); elsewhere the function
    itself. Each frame reseeds the generator with its seed first, as a
    fresh :func:`~mpgan_torch.solver.noise.frame_generator` is seeded. A
    graphed frame's state is the graph's output, which the next frame
    overwrites; :meth:`release` frees the graphs."""

    def __init__(self, step_fn, inputs, outputs_fn, seed: int, device,
                 generator: torch.Generator):
        self.inputs, self.seed, self.generator = inputs, seed, generator
        self.graphed = assemble.graphable(device)
        if self.graphed:
            step_fn = assemble.GraphedProgram(step_fn, (), device, generator)
            outputs_fn = assemble.GraphedProgram(outputs_fn, (), device)
        self.step_fn, self.outputs_fn = step_fn, outputs_fn

    def advance(self, state, t: int):
        self.generator.manual_seed(noise.frame_seed(self.seed, t))
        return type(state)(*self.step_fn(*self.inputs(state, t)))

    def outputs(self, state):
        return self.outputs_fn(state.density, state.velocity)

    def release(self) -> None:
        if self.graphed:
            self.step_fn.release()
            self.outputs_fn.release()


def scene_frames(sc: Scene, seed: int, up_res: int, device,
                 inflow_at: Callable[[int], torch.Tensor] | None = None
                 ) -> Frames:
    """The :class:`Frames` of a 3D scene on ``device`` (its tensors
    there). A moving :class:`Orbit` obstacle is built inside the step from
    its centre, a 0-d input filled per frame; any other ``solid_at(t)``
    (a test's injected masks) and ``inflow_at(t)`` fill static inputs."""
    inflow = sc.inflow.to(device)
    orbit = sc.solid_at if isinstance(sc.solid_at, Orbit) else None
    cx = torch.zeros((), device=device) if orbit is not None else None
    gen = torch.Generator(device=device)

    def frame_step(density, velocity, solid, cx, src):
        if cx is not None:
            solid = orbit.mask(cx)
        if src is None:
            src = noise.inflow_density(inflow, gen, strength=sc.strength)
        return tuple(smoke.step(smoke.SmokeState(density, velocity, solid),
                                sc.params, src, inflow))

    def inputs(state, t):
        solid = state.solid
        if orbit is not None:
            cx.fill_(orbit.cx(t))
            solid = None
        elif sc.solid_at is not None:
            solid = sc.solid_at(t).to(device)
        src = inflow_at(t).to(device) if inflow_at is not None else None
        return state.density, state.velocity, solid, cx, src

    def frame_outputs(density, velocity):
        # LR velocities in LR cell units (the models train on those)
        return (downsample_3d(density, up_res),
                downsample_3d(velocity, up_res) / up_res)

    return Frames(frame_step, inputs, frame_outputs, seed, device, gen)


def generate_sim(sim_dir: str, seed: int, res_hi: int, up_res: int,
                 frames: int, warmup: int = 8, with_obstacle: bool = False,
                 save_flags: bool = False, pressure_solver: str = "jacobi",
                 scene: str = "plume", write_high_vel: bool = True,
                 device=None, injected: Scene | None = None,
                 inflow_at: Callable[[int], torch.Tensor] | None = None
                 ) -> dict:
    """Run one simulation on ``device`` (the card unless the CPU is asked
    for) and write its LR/HR ``.uni`` pairs per frame; → timing stats,
    ``graphed`` among them.

    ``injected`` replaces the drawn scene and ``inflow_at(t)`` the noise of
    step t (both for tests)."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    os.makedirs(sim_dir, exist_ok=True)
    sc = injected if injected is not None else make_scene(
        seed, res_hi, scene, with_obstacle, pressure_solver, dev)
    state = smoke.SmokeState(*(t.to(dev) for t in sc.state))
    programs = scene_frames(sc, seed, up_res, dev, inflow_at)
    clock = _FrameClock(dev)
    try:
        for t in range(warmup):
            state = programs.advance(state, t)
        for f in range(frames):
            clock.start()
            state = programs.advance(state, warmup + f)
            dens_lo, vel_lo = programs.outputs(state)
            clock.computed()
            path = os.path.join(sim_dir, "{}_{:04d}.uni")
            uni.write_density(path.format("density_high", f),
                              _host(state.density)[..., 0])
            if write_high_vel:
                # nothing in training or evaluation reads the HR velocity,
                # but the reference's datagen writes it, so it stays the
                # default
                uni.write_velocity(path.format("velocity_high", f),
                                   _host(state.velocity))
            uni.write_density(path.format("density_low", f),
                              _host(dens_lo)[..., 0])
            uni.write_velocity(path.format("velocity_low", f),
                               _host(vel_lo))
            if save_flags:
                # mantaflow FlagGrid values: TypeFluid = 1, TypeObstacle = 2
                flags = 1 + _host(state.solid).astype(np.int32)
                uni.writeUni(path.format("flags", f),
                             uni.make_header(flags,
                                             grid_type=uni.TYPE_FLAGS),
                             flags)
            clock.written()
            _frame_progress(f)
    finally:
        programs.release()
    return dict(clock.stats(warmup + frames, time.perf_counter() - t_start),
                graphed=programs.graphed)


def generate_sim_2d(sim_dir: str, seed: int, res_hi: int, up_res: int,
                    frames: int, warmup: int = 8, with_obstacle: bool = False,
                    pressure_solver: str = "jacobi", device=None) -> dict:
    """A 2D scene (``dataDim 2``): writes (1, Y, X) ``.uni`` pairs, the
    velocities with vz = 0; → timing stats, ``graphed`` among them."""
    dev = resolve_device(device)
    t_start = time.perf_counter()
    os.makedirs(sim_dir, exist_ok=True)
    solid = None
    if with_obstacle:
        solid = smoke2d.disc_mask(res_hi, res_hi, (0.55, 0.5), 0.1, dev)
    state = smoke2d.init_state(res_hi, res_hi, solid, dev)
    inflow = smoke2d.disc_mask(res_hi, res_hi, (0.12, 0.5), 0.12, dev)
    if solid is not None:
        inflow = inflow * (1.0 - solid)
    params = smoke.SmokeParams(dt=0.5, buoyancy=2e-2, vorticity_eps=0.1,
                               jacobi_iters=50, maccormack=True,
                               pressure_solver=pressure_solver)
    gen = torch.Generator(device=dev)

    def frame_step(density, velocity, solid):
        n = noise.value_noise_3d((1, res_hi, res_hi), gen)[0]
        src = (0.5 + 0.5 * n)[..., None] * inflow
        return tuple(smoke2d.step(smoke2d.Smoke2DState(density, velocity,
                                                       solid),
                                  params, src, inflow))

    def frame_outputs(density, velocity):
        return (downsample_2d(density, up_res),
                downsample_2d(velocity, up_res) / up_res)

    def with_vz(v):                       # (Y, X, 2) → (1, Y, X, 3)
        return np.concatenate([v, np.zeros_like(v[..., :1])], -1)[None]

    programs = Frames(frame_step, lambda state, t: tuple(state),
                      frame_outputs, seed, dev, gen)
    clock = _FrameClock(dev)
    try:
        for t in range(warmup):
            state = programs.advance(state, t)
        for f in range(frames):
            clock.start()
            state = programs.advance(state, warmup + f)
            d_lo, v_lo = programs.outputs(state)
            clock.computed()
            path = os.path.join(sim_dir, "{}_{:04d}.uni")
            uni.write_density(path.format("density_high", f),
                              _host(state.density)[None, ..., 0])
            uni.write_velocity(path.format("velocity_high", f),
                               with_vz(_host(state.velocity)))
            uni.write_density(path.format("density_low", f),
                              _host(d_lo)[None, ..., 0])
            uni.write_velocity(path.format("velocity_low", f),
                               with_vz(_host(v_lo)))
            clock.written()
            _frame_progress(f)
    finally:
        programs.release()
    return dict(clock.stats(warmup + frames, time.perf_counter() - t_start),
                graphed=programs.graphed)


def with_obstacle(sim: int, obstacles_every: int) -> bool:
    """Obstacle cadence keyed on the sim id (not its position in a sweep),
    so a resumed sweep with another fromSim gives each sim id the same
    scene; the skip-existing check depends on that."""
    return obstacles_every > 0 and sim % obstacles_every == obstacles_every - 1


def sim_scene_policy(scene: str, sim: int,
                     obstacles_every: int) -> tuple[bool, bool]:
    """(with_obstacle, save_flags) of one sim, shared by
    :func:`generate_dataset` and :mod:`mpgan_torch.datagen`: the randomised
    families always write flags (their obstacles are drawn per sim)."""
    with_obs = scene == "plume" and with_obstacle(sim, obstacles_every)
    return with_obs, with_obs or scene != "plume"


def generate_dataset(base_path: str, from_sim: int, to_sim: int, res_hi: int,
                     up_res: int, frames: int, seed: int = 0,
                     obstacles_every: int = 0, scene: str = "plume",
                     write_high_vel: bool = True, device=None) -> None:
    """Generate ``sim_%04d`` for the ids [from_sim, to_sim], each from the
    seed ``seed + sim``."""
    for sim in range(from_sim, to_sim + 1):
        with_obs, save_flags = sim_scene_policy(scene, sim, obstacles_every)
        generate_sim(os.path.join(base_path, f"sim_{sim:04d}"), seed + sim,
                     res_hi, up_res, frames, with_obstacle=with_obs,
                     save_flags=save_flags, scene=scene,
                     write_high_vel=write_high_vel, device=device)
