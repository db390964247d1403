"""Buoyant-smoke solver in PyTorch — counterpart of
``mpgan_tpu/solver/smoke.py``, the stand-in for mantaflow that generates
training data.

Semi-Lagrangian / MacCormack advection, buoyancy, vorticity confinement,
noise-modulated inflow, optional solid obstacles, and Jacobi or
conjugate-gradient pressure projection. Cells store density (Z, Y, X, 1)
and velocity (Z, Y, X, 3), channels (vx, vy, vz) on axes (2, 1, 0), where
component c is the face value on the cell's +face (MAC-style). Divergence
takes backward differences and the pressure gradient forward ones; their
composition is the compact 7-point Laplacian. The domain is a closed box
(zero normal velocity at the walls, Neumann pressure); obstacles are a
solid mask with zero velocity and masked projection.

Everything runs on the tensors' device as eager ops. Where XLA hoists
loop invariants out of ``fori_loop`` (the fluid-mask shifts of the Jacobi
and CG loops), the port hoists them by hand; the values stay the same. The
CG freeze stays on the device (``torch.where`` on 0-dim tensors): a Python
``if`` on a residual would synchronise every iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from mpgan_torch.ops.warp import advect_3d, advect_3d_maccormack


class SmokeState(NamedTuple):
    density: torch.Tensor   # (Z, Y, X, 1) float32
    velocity: torch.Tensor  # (Z, Y, X, 3) float32, channels (vx, vy, vz)
    solid: torch.Tensor     # (Z, Y, X, 1) float32 in {0, 1}; 1 = obstacle


@dataclass(frozen=True)
class SmokeParams:
    dt: float = 0.5
    buoyancy: float = 1.0e-2       # upward (+y) force ∝ density
    vorticity_eps: float = 0.05    # confinement strength; 0 disables
    jacobi_iters: int = 60
    maccormack: bool = True
    dissipation: float = 0.0       # density decay per step
    pressure_solver: str = "jacobi"  # "jacobi" | "cg" (mantaflow uses CG)
    cg_iters: int = 60


# ------------------------------------------------------------------ stencils

def _shift(a: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """Neighbour access with edge replication: out[i] = a[clip(i + off)],
    for off = ±1 (a clamped gather, not a roll)."""
    n = a.shape[axis]
    if n == 1:
        return a
    if off == 1:
        return torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                         dim=axis)
    if off == -1:
        return torch.cat([a.narrow(axis, 0, 1), a.narrow(axis, 0, n - 1)],
                         dim=axis)
    raise ValueError(f"_shift takes off = ±1, got {off}")


def _bdiff(a: torch.Tensor, axis: int) -> torch.Tensor:
    """a[i] − a[i − 1], with 0 standing for the face below the wall."""
    n = a.shape[axis]
    below = torch.cat([torch.zeros_like(a.narrow(axis, 0, 1)),
                       a.narrow(axis, 0, n - 1)], dim=axis)
    return a - below


def divergence(vel: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence of +face velocities in a closed box:
    div[i] = vx[i] − vx[i−1] + vy[j] − vy[j−1] + vz[k] − vz[k−1], where the
    −1 face at the domain wall is 0 (the far wall's +face is forced to 0 by
    :func:`enforce_boundaries`)."""
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    return (_bdiff(vx, 2) + _bdiff(vy, 1) + _bdiff(vz, 0))[..., None]


def pressure_gradient(p: torch.Tensor) -> torch.Tensor:
    """Forward-difference gradient at +faces; far-wall faces get 0."""
    p3 = p[..., 0]
    return torch.stack([_shift(p3, 1, a) - p3 for a in (2, 1, 0)], dim=-1)


def _neighbour_masks(fluid: torch.Tensor) -> list[tuple[int, int,
                                                        torch.Tensor]]:
    """(axis, off, neighbour is fluid) for every axis and off = −1, +1, in
    the loops' order. The masks do not change between iterations."""
    return [(axis, off, _shift(fluid, off, axis) > 0)
            for axis in range(fluid.dim()) for off in (-1, 1)]


def jacobi_pressure(div: torch.Tensor, solid: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """Solve ∇²p = div with Jacobi; Neumann walls, solid cells excluded (a
    solid neighbour contributes the centre value)."""
    fluid = 1.0 - solid[..., 0]
    d = div[..., 0]
    masks = _neighbour_masks(fluid)
    is_fluid = fluid > 0
    cnt = float(len(masks))
    p = torch.zeros_like(d)
    for _ in range(iters):
        s = torch.zeros_like(p)
        for axis, off, fn in masks:
            s = s + torch.where(fn, _shift(p, off, axis), p)
        p = torch.where(is_fluid, (s - d) / cnt, 0.0)
    return p[..., None]


def _laplace_apply(p: torch.Tensor, fluid: torch.Tensor,
                   masks=None) -> torch.Tensor:
    """Matrix-free Neumann Laplacian, dimension-generic:
    (A p)[c] = Σ_{fluid neighbours n} (p[c] − p[n]), restricted to fluid
    cells. Walls contribute 0 through the edge replication, solids through
    the mask. ``masks`` are :func:`_neighbour_masks` of ``fluid``."""
    if masks is None:
        masks = _neighbour_masks(fluid)
    out = torch.zeros_like(p)
    for axis, off, fn in masks:
        out = out + torch.where(fn, p - _shift(p, off, axis), 0.0)
    return out * fluid


def cg_pressure(div: torch.Tensor, solid: torch.Tensor,
                iters: int) -> torch.Tensor:
    """Solve the projection's Poisson system (A p = −div on fluid cells,
    the system Jacobi iterates) with conjugate gradients, a fixed number of
    iterations. Past |r|² ≤ 1e-12·|b|² every update is frozen: beyond
    float32 convergence the recurrence's round-off drifts r away from the
    true residual. The freeze and the guarded divisions are ``torch.where``
    on 0-dim tensors, so the loop never waits for the device."""
    fluid = 1.0 - solid[..., 0]
    masks = _neighbour_masks(fluid)
    b = -div[..., 0] * fluid

    def dot(a, c):
        return torch.sum(a * c)

    rs = dot(b, b)
    tol2 = 1e-12 * rs
    p, r, q = torch.zeros_like(b), b, b
    for _ in range(iters):
        done = rs <= tol2
        aq = _laplace_apply(q, fluid, masks)
        denom = dot(q, aq)
        alpha = torch.where(done | (denom <= 0), 0.0,
                            rs / torch.clamp_min(denom, 1e-30))
        p = p + alpha * q
        r = r - alpha * aq
        rs_new = torch.where(done, rs, dot(r, r))
        beta = torch.where(done | (rs <= 0), 0.0,
                           rs_new / torch.clamp_min(rs, 1e-30))
        q = torch.where(done, q, r + beta * q)
        rs = rs_new
    return (p * fluid)[..., None]


def enforce_boundaries(vel: torch.Tensor, solid: torch.Tensor
                       ) -> torch.Tensor:
    """Zero the +face velocities at the far walls and on faces touching a
    solid cell (either side)."""
    vel = vel.clone()
    vel[:, :, -1, 0] = 0.0
    vel[:, -1, :, 1] = 0.0
    vel[-1, :, :, 2] = 0.0
    s = solid[..., 0]
    mask = torch.stack([torch.maximum(s, _shift(s, 1, a)) for a in (2, 1, 0)],
                       dim=-1)
    return vel * (1.0 - mask)


def project(vel: torch.Tensor, solid: torch.Tensor, iters: int,
            solver: str = "jacobi") -> torch.Tensor:
    """Make ``vel`` discretely divergence-free on the fluid cells."""
    vel = enforce_boundaries(vel, solid)
    div = divergence(vel) * (1.0 - solid)
    if solver == "cg":
        p = cg_pressure(div, solid, iters)
    else:
        p = jacobi_pressure(div, solid, iters)
    vel = vel - pressure_gradient(p)
    return enforce_boundaries(vel, solid)


def _central(a: torch.Tensor, axis: int) -> torch.Tensor:
    return 0.5 * (_shift(a, 1, axis) - _shift(a, -1, axis))


def vorticity_confinement(vel: torch.Tensor, eps: float,
                          dt: float) -> torch.Tensor:
    """Re-inject the small-scale swirl that semi-Lagrangian advection
    dissipates (Fedkiw et al.)."""
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    # ω = ∇×v ; axes: 0=z, 1=y, 2=x
    wx = _central(vz, 1) - _central(vy, 0)
    wy = _central(vx, 0) - _central(vz, 2)
    wz = _central(vy, 2) - _central(vx, 1)
    wmag = torch.sqrt(wx * wx + wy * wy + wz * wz + 1e-20)
    nx, ny, nz = _central(wmag, 2), _central(wmag, 1), _central(wmag, 0)
    nmag = torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-20)
    nx, ny, nz = nx / nmag, ny / nmag, nz / nmag
    force = torch.stack([ny * wz - nz * wy, nz * wx - nx * wz,
                         nx * wy - ny * wx], dim=-1)
    return vel + eps * dt * force


# ------------------------------------------------------------------ stepping

def add_buoyancy(vel: torch.Tensor, dens: torch.Tensor,
                 params: SmokeParams) -> torch.Tensor:
    """Upward force on channel 1: dt · 100 · buoyancy · density."""
    vel = vel.clone()
    vel[..., 1] += params.buoyancy * dens[..., 0] * params.dt * 100.0
    return vel


def step(state: SmokeState, params: SmokeParams,
         inflow_density: torch.Tensor | None = None,
         inflow_mask: torch.Tensor | None = None) -> SmokeState:
    """One solver step. ``inflow_density`` (Z, Y, X, 1) is blended in where
    ``inflow_mask`` (Z, Y, X, 1 in [0, 1]) is positive. The plain
    function; as a CUDA graph per (shape, params, inflow given), the
    counterpart of JAX's jitted step:
    :class:`mpgan_torch.solver.graphed.GraphedStep`."""
    dens, vel, solid = state
    if params.maccormack:
        dens = advect_3d_maccormack(dens, vel, params.dt)
    else:
        dens = advect_3d(dens, vel, params.dt)
    vel = advect_3d(vel, vel, params.dt)
    vel = add_buoyancy(vel, dens, params)
    if params.vorticity_eps > 0:
        vel = vorticity_confinement(vel, params.vorticity_eps, params.dt)
    if inflow_density is not None and inflow_mask is not None:
        dens = dens * (1.0 - inflow_mask) + inflow_density * inflow_mask
    if params.dissipation > 0:
        dens = dens * (1.0 - params.dissipation)
    dens = dens * (1.0 - solid)
    if params.pressure_solver == "cg":
        vel = project(vel, solid, params.cg_iters, solver="cg")
    else:
        vel = project(vel, solid, params.jacobi_iters)
    return SmokeState(dens, vel, solid)


def init_state(res_z: int, res_y: int, res_x: int,
               solid: torch.Tensor | None = None, device=None) -> SmokeState:
    """Empty fields on ``device`` (``solid``'s device when it is given)."""
    if solid is None:
        solid = torch.zeros((res_z, res_y, res_x, 1), device=device)
    z = torch.zeros((res_z, res_y, res_x, 1), device=solid.device)
    return SmokeState(density=z,
                      velocity=torch.zeros((res_z, res_y, res_x, 3),
                                           device=solid.device),
                      solid=solid)


def sphere_mask(res_z: int, res_y: int, res_x: int,
                center: tuple[float, float, float], radius: float,
                device=None) -> torch.Tensor:
    """(Z, Y, X, 1) hard sphere mask; centre and radius in fractions of the
    domain, the squared distance in float32 as JAX computes it."""
    zz = torch.arange(res_z, dtype=torch.float32, device=device)[:, None,
                                                                  None] / res_z
    yy = torch.arange(res_y, dtype=torch.float32, device=device)[None, :,
                                                                  None] / res_y
    xx = torch.arange(res_x, dtype=torch.float32, device=device)[None, None,
                                                                  :] / res_x
    cz, cy, cx = center
    r2 = (zz - cz) ** 2 + (yy - cy) ** 2 + (xx - cx) ** 2
    return (r2 < radius * radius).to(torch.float32)[..., None]
