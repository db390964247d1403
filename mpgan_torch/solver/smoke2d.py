"""2D buoyant-smoke solver (``dataDim 2``) — counterpart of
``mpgan_tpu/solver/smoke2d.py``.

The discretisation of :mod:`mpgan_torch.solver.smoke` in two dimensions:
+face velocities, backward-difference divergence and forward-difference
pressure gradient (the compact 5-point Laplacian), a closed box. Fields are
(H, W, C) with y up; velocity channels (vx, vy). The CG solve is the
dimension-generic :func:`mpgan_torch.solver.smoke.cg_pressure`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mpgan_torch.ops.warp import advect_2d, advect_2d_maccormack
from mpgan_torch.solver.smoke import (SmokeParams, _bdiff, _central,
                                      _neighbour_masks, _shift, add_buoyancy,
                                      cg_pressure)


class Smoke2DState(NamedTuple):
    density: torch.Tensor   # (H, W, 1)
    velocity: torch.Tensor  # (H, W, 2) channels (vx, vy)
    solid: torch.Tensor     # (H, W, 1)


def divergence(vel: torch.Tensor) -> torch.Tensor:
    return (_bdiff(vel[..., 0], 1) + _bdiff(vel[..., 1], 0))[..., None]


def pressure_gradient(p: torch.Tensor) -> torch.Tensor:
    p2 = p[..., 0]
    return torch.stack([_shift(p2, 1, 1) - p2, _shift(p2, 1, 0) - p2],
                       dim=-1)


def jacobi_pressure(div: torch.Tensor, solid: torch.Tensor,
                    iters: int) -> torch.Tensor:
    fluid = 1.0 - solid[..., 0]
    d = div[..., 0]
    masks = _neighbour_masks(fluid)
    is_fluid = fluid > 0
    p = torch.zeros_like(d)
    for _ in range(iters):
        s = torch.zeros_like(p)
        for axis, off, fn in masks:
            s = s + torch.where(fn, _shift(p, off, axis), p)
        p = torch.where(is_fluid, (s - d) / 4.0, 0.0)
    return p[..., None]


def enforce_boundaries(vel: torch.Tensor, solid: torch.Tensor
                       ) -> torch.Tensor:
    vx = vel[..., 0].clone()
    vy = vel[..., 1].clone()
    vx[:, -1] = 0.0
    vy[-1, :] = 0.0
    s = solid[..., 0]
    sx = torch.maximum(s, _shift(s, 1, 1))
    sy = torch.maximum(s, _shift(s, 1, 0))
    return torch.stack([vx * (1 - sx), vy * (1 - sy)], dim=-1)


def project(vel: torch.Tensor, solid: torch.Tensor, iters: int,
            solver: str = "jacobi") -> torch.Tensor:
    vel = enforce_boundaries(vel, solid)
    div = divergence(vel) * (1.0 - solid)
    if solver == "cg":
        p = cg_pressure(div, solid, iters)
    else:
        p = jacobi_pressure(div, solid, iters)
    return enforce_boundaries(vel - pressure_gradient(p), solid)


def vorticity_confinement(vel: torch.Tensor, eps: float,
                          dt: float) -> torch.Tensor:
    vx, vy = vel[..., 0], vel[..., 1]
    w = _central(vy, 1) - _central(vx, 0)  # scalar curl
    wabs = torch.abs(w)
    ny, nx = _central(wabs, 0), _central(wabs, 1)
    mag = torch.sqrt(nx * nx + ny * ny + 1e-20)
    nx, ny = nx / mag, ny / mag
    # force = ε (N × ω ẑ): fx = ny·w, fy = −nx·w
    return vel + eps * dt * torch.stack([ny * w, -nx * w], dim=-1)


def step(state: Smoke2DState, params: SmokeParams,
         inflow_density: torch.Tensor | None = None,
         inflow_mask: torch.Tensor | None = None) -> Smoke2DState:
    """One 2D solver step, as :func:`mpgan_torch.solver.smoke.step`
    (graphed: ``GraphedStep(smoke2d.step)``)."""
    dens, vel, solid = state
    if params.maccormack:
        dens = advect_2d_maccormack(dens, vel, params.dt)
    else:
        dens = advect_2d(dens[None], vel[None], params.dt)[0]
    vel = advect_2d(vel[None], vel[None], params.dt)[0]
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
    return Smoke2DState(dens, vel, solid)


def init_state(res_y: int, res_x: int, solid: torch.Tensor | None = None,
               device=None) -> Smoke2DState:
    if solid is None:
        solid = torch.zeros((res_y, res_x, 1), device=device)
    return Smoke2DState(torch.zeros((res_y, res_x, 1), device=solid.device),
                        torch.zeros((res_y, res_x, 2), device=solid.device),
                        solid)


def disc_mask(res_y: int, res_x: int, center: tuple[float, float],
              radius: float, device=None) -> torch.Tensor:
    yy = torch.arange(res_y, dtype=torch.float32, device=device)[:, None] \
        / res_y
    xx = torch.arange(res_x, dtype=torch.float32, device=device)[None, :] \
        / res_x
    cy, cx = center
    return (((yy - cy) ** 2 + (xx - cx) ** 2 < radius ** 2)
            .to(torch.float32)[..., None])
