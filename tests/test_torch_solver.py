"""The port's smoke solver, MacCormack advection, value noise and
downsampling vs the JAX package on the CPU, one stencil at a time, on
12³–16³ fields made from a numpy seed, and the physics checks of
tests/test_solver.py on the port.

Tolerances: data movement (shifts, masks, the limiter's stencil min/max)
is exact; one stencil or one advection 1e-6 (float32 rounding of the same
terms: XLA fuses and may contract into FMAs, PyTorch's eager ops do not);
pressure solves, projections and whole steps 1e-5 (30–50 sweeps of that
rounding, and CG's dot products sum in another order); noise and
downsampling 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch.ops import resample as tres
from mpgan_torch.ops import warp as twarp
from mpgan_torch.solver import noise as tnoise
from mpgan_torch.solver import smoke as tsmoke
from mpgan_torch.solver import smoke2d as tsmoke2d
from mpgan_tpu.ops import resample as jres
from mpgan_tpu.ops import warp as jwarp
from mpgan_tpu.solver import noise as jnoise
from mpgan_tpu.solver import smoke as jsmoke
from mpgan_tpu.solver import smoke2d as jsmoke2d

torch.set_num_threads(1)


def _fields(shape, seed, channels=3, scale=1.0):
    rng = np.random.default_rng(seed)
    dens = rng.random(shape + (1,), dtype=np.float32)
    vel = (rng.standard_normal(shape + (channels,)) * scale).astype(
        np.float32)
    return dens, vel


def _solid(n=16, dim=3):
    if dim == 2:
        return np.asarray(jsmoke2d.disc_mask(n, n, (0.5, 0.5), 0.2))
    return np.asarray(jsmoke.sphere_mask(n, n, n, (0.5, 0.45, 0.5), 0.22))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("off", [-1, 1])
def test_shift_replicates_the_edge(axis, off):
    a = np.random.default_rng(axis).random((5, 6, 7), dtype=np.float32)
    np.testing.assert_array_equal(tsmoke._shift(T(a), off, axis).numpy(),
                                  np.asarray(jsmoke._shift(J(a), off, axis)))


def test_masks_match_jax():
    np.testing.assert_array_equal(
        tsmoke.sphere_mask(16, 14, 12, (0.5, 0.4, 0.6), 0.25).numpy(),
        np.asarray(jsmoke.sphere_mask(16, 14, 12, (0.5, 0.4, 0.6), 0.25)))
    np.testing.assert_array_equal(
        tsmoke2d.disc_mask(20, 18, (0.3, 0.5), 0.2).numpy(),
        np.asarray(jsmoke2d.disc_mask(20, 18, (0.3, 0.5), 0.2)))


@pytest.mark.parametrize("obstacle", [False, True])
def test_stencils_match_jax(obstacle):
    dens, vel = _fields((16, 16, 16), 1)
    solid = _solid() if obstacle else np.zeros_like(dens)
    _close(tsmoke.divergence(T(vel)), jsmoke.divergence(J(vel)), 1e-6)
    _close(tsmoke.pressure_gradient(T(dens)),
           jsmoke.pressure_gradient(J(dens)), 1e-6)
    np.testing.assert_array_equal(
        tsmoke.enforce_boundaries(T(vel), T(solid)).numpy(),
        np.asarray(jsmoke.enforce_boundaries(J(vel), J(solid))))
    _close(tsmoke.vorticity_confinement(T(vel), 0.1, 0.5),
           jsmoke.vorticity_confinement(J(vel), 0.1, 0.5), 1e-6)
    fluid = 1.0 - solid[..., 0]
    _close(tsmoke._laplace_apply(T(dens[..., 0]), T(fluid)),
           jsmoke._laplace_apply(J(dens[..., 0]), J(fluid)), 1e-6)


@pytest.mark.parametrize("obstacle", [False, True])
def test_pressure_solves_match_jax(obstacle):
    _, vel = _fields((16, 16, 16), 2)
    solid = _solid() if obstacle else np.zeros(vel.shape[:3] + (1,),
                                               np.float32)
    div = np.asarray(jsmoke.divergence(jsmoke.enforce_boundaries(
        J(vel), J(solid)))) * (1.0 - solid)
    _close(tsmoke.jacobi_pressure(T(div), T(solid), 30),
           jsmoke.jacobi_pressure(J(div), J(solid), 30), 1e-5)
    _close(tsmoke.cg_pressure(T(div), T(solid), 30),
           jsmoke.cg_pressure(J(div), J(solid), 30), 1e-5)
    for solver in ("jacobi", "cg"):
        _close(tsmoke.project(T(vel), T(solid), 30, solver),
               jsmoke.project(J(vel), J(solid), 30, solver), 1e-5)


@pytest.mark.parametrize("dt,vscale", [(0.5, 1.5), (-1.0, 3.0), (0.5, 0.0)])
def test_maccormack_matches_jax(dt, vscale):
    dens, vel = _fields((12, 13, 14), int(vscale * 7) + 3, scale=vscale)
    _close(twarp.advect_3d_maccormack(T(dens), T(vel), dt),
           jwarp.advect_3d_maccormack(J(dens), J(vel), dt), 1e-6)
    for got, want in zip(twarp._stencil_minmax_3d(T(dens), T(vel), dt),
                         jwarp._stencil_minmax_3d(J(dens), J(vel), dt)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    img, v2 = dens[0], vel[0, ..., :2]
    _close(twarp.advect_2d_maccormack(T(img), T(v2), dt),
           jwarp.advect_2d_maccormack(J(img), J(v2), dt), 1e-6)
    for got, want in zip(twarp._stencil_minmax_2d(T(img), T(v2), dt),
                         jwarp._stencil_minmax_2d(J(img), J(v2), dt)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if vscale == 0.0:
        np.testing.assert_array_equal(
            twarp.advect_3d_maccormack(T(dens), T(vel), dt).numpy(), dens)


def _jax_coarse(key, shape, base_res=4, octaves=3):
    """The coarse grids JAX's value_noise_3d draws from ``key``."""
    out = []
    for o in range(octaves):
        key, sub = jax.random.split(key)
        r = base_res * 2 ** o
        out.append(np.asarray(jax.random.uniform(
            sub, tuple(min(r, n) for n in shape))))
    return out


@pytest.mark.parametrize("shape", [(16, 16, 16), (12, 10, 14), (1, 24, 24)])
def test_noise_on_injected_grids_matches_jax(shape):
    """jax.image.resize 'linear' and trilinear interpolate with
    align_corners=False agree at integer and at other ratios."""
    key = jax.random.PRNGKey(sum(shape))
    coarse = _jax_coarse(key, shape)
    assert [c.shape for c in coarse] == tnoise.coarse_shapes(shape)
    want = np.asarray(jnoise.value_noise_3d(key, shape))
    got = tnoise.value_noise_3d(shape, coarse=coarse)
    _close(got, want, 1e-6)
    mask = np.asarray(jsmoke.sphere_mask(*shape, (0.5, 0.2, 0.5), 0.3))
    t = 5
    want = jnoise.time_varying_inflow(key, J(mask), t, strength=0.9)
    got = tnoise.time_varying_inflow(
        0, T(mask), t, strength=0.9,
        coarse=_jax_coarse(jax.random.fold_in(key, t), shape))
    _close(got, want, 1e-6)


def test_noise_draws_are_seeded_and_in_range():
    g = tnoise.frame_generator(3, 7, "cpu")
    a = tnoise.value_noise_3d((16, 16, 16), g)
    b = tnoise.value_noise_3d((16, 16, 16), tnoise.frame_generator(3, 7,
                                                                    "cpu"))
    c = tnoise.value_noise_3d((16, 16, 16), tnoise.frame_generator(3, 8,
                                                                    "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0
    assert float(a.diff(dim=0).abs().mean()) < 0.2


@pytest.mark.parametrize("factor", [2, 4])
def test_downsample_matches_jax(factor):
    dens, vel = _fields((16, 16, 16), factor)
    _close(tres.downsample_3d(T(vel), factor),
           jres.downsample_3d(J(vel), factor), 1e-6)
    _close(tres.downsample_2d(T(dens[0]), factor),
           jres.downsample_2d(J(dens[0]), factor), 1e-6)
    np.testing.assert_array_equal(tres.downsample_3d(T(vel), 1).numpy(), vel)


@pytest.mark.parametrize("solver,maccormack,obstacle", [
    ("jacobi", True, True), ("cg", True, True), ("jacobi", False, False),
    ("cg", True, False)])
def test_step_matches_jax(solver, maccormack, obstacle):
    n = 14
    dens, vel = _fields((n, n, n), 5, scale=0.5)
    solid = _solid(n) if obstacle else np.zeros_like(dens)
    dens, vel = dens * (1 - solid), vel * (1 - solid)
    inflow = np.asarray(jsmoke.sphere_mask(n, n, n, (0.5, 0.12, 0.5), 0.2))
    src = np.random.default_rng(6).random(inflow.shape, dtype=np.float32)
    params = jsmoke.SmokeParams(dt=0.5, buoyancy=2e-2, vorticity_eps=0.1,
                                jacobi_iters=50, maccormack=maccormack,
                                pressure_solver=solver, cg_iters=40)
    want = jsmoke.step(jsmoke.SmokeState(J(dens), J(vel), J(solid)), params,
                       J(src), J(inflow))
    got = tsmoke.step(tsmoke.SmokeState(T(dens), T(vel), T(solid)),
                      tsmoke.SmokeParams(**params.__dict__), T(src),
                      T(inflow))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("solver", ["jacobi", "cg"])
def test_step_2d_matches_jax(solver):
    n = 16
    dens, vel = _fields((n, n), 7, channels=2, scale=0.5)
    solid = _solid(n, dim=2)
    inflow = np.asarray(jsmoke2d.disc_mask(n, n, (0.12, 0.5), 0.2))
    src = np.random.default_rng(8).random(inflow.shape, dtype=np.float32)
    params = jsmoke.SmokeParams(dt=0.5, buoyancy=2e-2, vorticity_eps=0.1,
                                jacobi_iters=50, pressure_solver=solver,
                                cg_iters=40)
    state = (dens * (1 - solid), vel * (1 - solid), solid)
    want = jsmoke2d.step(jsmoke2d.Smoke2DState(*map(J, state)), params,
                         J(src), J(inflow))
    got = tsmoke2d.step(tsmoke2d.Smoke2DState(*map(T, state)),
                        tsmoke.SmokeParams(**params.__dict__), T(src),
                        T(inflow))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)
    _close(tsmoke2d.vorticity_confinement(T(vel), 0.1, 0.5),
           jsmoke2d.vorticity_confinement(J(vel), 0.1, 0.5), 1e-6)


# ------------------------------------------------ physics (tests/test_solver)

def _mean_div(vel, solid, div_fn=tsmoke.divergence):
    return float((div_fn(vel) * (1.0 - solid)).abs().mean())


def test_projection_kills_divergence():
    vel = T(np.random.default_rng(0).standard_normal(
        (16, 16, 16, 3)).astype(np.float32))
    solid = torch.zeros((16, 16, 16, 1))
    before = _mean_div(tsmoke.enforce_boundaries(vel, solid), solid)
    after = _mean_div(tsmoke.project(vel, solid, iters=200), solid)
    assert after < 0.05 * before, (before, after)
    vel2 = T(np.random.default_rng(0).standard_normal(
        (24, 24, 2)).astype(np.float32))
    solid2 = torch.zeros((24, 24, 1))
    before = _mean_div(tsmoke2d.enforce_boundaries(vel2, solid2), solid2,
                       tsmoke2d.divergence)
    after = _mean_div(tsmoke2d.project(vel2, solid2, 200), solid2,
                      tsmoke2d.divergence)
    assert after < 0.05 * before, (before, after)


def _plume(res, solid, steps, params, seed=0):
    state = tsmoke.init_state(res, res, res, solid)
    inflow = tsmoke.sphere_mask(res, res, res, (0.5, 0.15, 0.5), 0.15)
    if solid is not None:
        inflow = inflow * (1.0 - solid)
    states = []
    for t in range(steps):
        src = tnoise.time_varying_inflow(seed, inflow, t)
        state = tsmoke.step(state, params, src, inflow)
        states.append(state)
    return states


def _com_y(d):
    return float((d * torch.arange(d.shape[1])[None, :, None]).sum()
                 / d.sum().clamp_min(1e-6))


def test_buoyancy_makes_plume_rise():
    states = _plume(24, None, 12, tsmoke.SmokeParams(jacobi_iters=30))
    d0, d1 = states[3].density[..., 0], states[-1].density[..., 0]
    assert bool(torch.isfinite(d1).all())
    assert float(d1.min()) >= -1e-4       # the limiter keeps it non-negative
    assert _com_y(d1) > _com_y(d0) + 0.3, (_com_y(d0), _com_y(d1))


def test_solid_obstacle_stays_empty():
    res = 20
    solid = tsmoke.sphere_mask(res, res, res, (0.5, 0.5, 0.5), 0.2)
    state = _plume(res, solid, 10, tsmoke.SmokeParams(jacobi_iters=30),
                   seed=1)[-1]
    assert float((state.density * solid).max()) < 1e-5
    assert float((state.velocity * solid).abs().max()) < 1e-5


def test_cg_projection_beats_jacobi_at_equal_iters():
    vel = T(np.random.default_rng(2).standard_normal(
        (16, 16, 16, 3)).astype(np.float32))
    solid = tsmoke.sphere_mask(16, 16, 16, (0.5, 0.5, 0.5), 0.2)
    vel = vel * (1.0 - solid)
    after_j = _mean_div(tsmoke.project(vel, solid, iters=60), solid)
    after_cg = _mean_div(tsmoke.project(vel, solid, iters=60, solver="cg"),
                         solid)
    assert after_cg < 0.05 * after_j, (after_j, after_cg)


def test_cg_iterating_past_convergence_is_safe():
    vel = T(np.random.default_rng(3).standard_normal(
        (12, 12, 12, 3)).astype(np.float32))
    solid = torch.zeros((12, 12, 12, 1))
    out = tsmoke.project(vel, solid, iters=2000, solver="cg")
    assert bool(torch.isfinite(out).all())
    assert _mean_div(out, solid) < 1e-4
