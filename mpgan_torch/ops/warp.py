"""Semi-Lagrangian frame warping (plain PyTorch).

Counterpart of ``mpgan_tpu/ops/warp.py`` ``advect_2d`` / ``advect_2d_batch``:
for each target cell, sample the source field at the backtraced position
``x − dt·v(x)`` with border-clamped bilinear interpolation. Velocity
channels are (v_w, v_h) — x component first — and are reversed to (y, x)
coordinates. :func:`advect_3d` is the same warp in 3D, unclamped, with
trilinear taps (the temporal-coherence metric of :mod:`mpgan_torch.eval`
and the smoke solver's advection). :func:`advect_2d_maccormack` and
:func:`advect_3d_maccormack` are the solver's second-order advection with
the min/max limiter; the 2D one takes the solver's unbatched (H, W, C)
fields.

The CUDA kernel for the 2D warp (with a displacement clamp) is in
:mod:`mpgan_torch.ops.warp_kernel`.
"""

from __future__ import annotations

import torch

from mpgan_torch.ops.interp import (bilinear_sample, grid_coords_2d,
                                    grid_coords_3d, trilinear_sample)


def advect_2d(field: torch.Tensor, vel: torch.Tensor,
              dt: float = 1.0) -> torch.Tensor:
    """Advect ``field`` (B, H, W, C) by ``vel`` (B, H, W, 2) as (v_w, v_h)."""
    _, h, w, _ = field.shape
    base = grid_coords_2d(h, w, dtype=field.dtype, device=field.device)
    back = base - dt * vel.flip(-1)  # (v_w, v_h) → (y, x) order
    return bilinear_sample(field, back)


def advect_3d(field: torch.Tensor, vel: torch.Tensor,
              dt: float = 1.0) -> torch.Tensor:
    """Advect ``field`` (Z, Y, X, C) by ``vel`` (Z, Y, X, 3) as
    (vx, vy, vz)."""
    d, h, w, _ = field.shape
    base = grid_coords_3d(d, h, w, dtype=field.dtype, device=field.device)
    back = base - dt * vel.flip(-1)  # (vx, vy, vz) → (z, y, x) order
    return trilinear_sample(field, back)


def advect_2d_maccormack(field: torch.Tensor, vel: torch.Tensor,
                         dt: float = 1.0, strength: float = 1.0
                         ) -> torch.Tensor:
    """MacCormack/BFECC advection of ``field`` (H, W, C) by ``vel``
    (H, W, 2): forward = SL(field, dt); backward = SL(forward, −dt);
    corrected = forward + strength·(field − backward)/2, clamped to the
    min/max of the forward step's interpolation stencil."""
    fwd = advect_2d(field[None], vel[None], dt)[0]
    bwd = advect_2d(fwd[None], vel[None], -dt)[0]
    corr = fwd + 0.5 * strength * (field - bwd)
    lo, hi = _stencil_minmax_2d(field, vel, dt)
    return torch.minimum(torch.maximum(corr, lo), hi)


def advect_3d_maccormack(field: torch.Tensor, vel: torch.Tensor,
                         dt: float = 1.0, strength: float = 1.0
                         ) -> torch.Tensor:
    """MacCormack/BFECC advection of ``field`` (Z, Y, X, C) by ``vel``
    (Z, Y, X, 3), limited as :func:`advect_2d_maccormack`."""
    fwd = advect_3d(field, vel, dt)
    bwd = advect_3d(fwd, vel, -dt)
    corr = fwd + 0.5 * strength * (field - bwd)
    lo, hi = _stencil_minmax_3d(field, vel, dt)
    return torch.minimum(torch.maximum(corr, lo), hi)


def _corner_minmax(field: torch.Tensor, lows, highs, sizes):
    """Min and max of ``field`` (..., C) over the 2^n corners of each
    cell's stencil: ``lows``/``highs`` are the per-axis corner indices,
    ``sizes`` the axis lengths."""
    flat = field.reshape(-1, field.shape[-1])
    idx = [0]
    for lo, hi, n in zip(lows, highs, sizes):
        idx = [i * n + c for i in idx for c in (lo, hi)]
    vals = flat[torch.stack(idx)]                     # (2^n, ..., C)
    return vals.amin(dim=0), vals.amax(dim=0)


def _stencil_corners(back: torch.Tensor, sizes):
    """Per-axis floor and floor + 1 of the backtraced coordinates, clamped
    to the grid (the JAX package's clip order)."""
    lows, highs = [], []
    for a, n in enumerate(sizes):
        lo = torch.floor(back[..., a]).to(torch.int64).clamp(0, n - 1)
        lows.append(lo)
        highs.append((lo + 1).clamp(max=n - 1))
    return lows, highs


def _stencil_minmax_2d(field: torch.Tensor, vel: torch.Tensor, dt: float):
    h, w, _ = field.shape
    back = grid_coords_2d(h, w, dtype=field.dtype,
                          device=field.device) - dt * vel.flip(-1)
    return _corner_minmax(field, *_stencil_corners(back, (h, w)), (h, w))


def _stencil_minmax_3d(field: torch.Tensor, vel: torch.Tensor, dt: float):
    d, h, w, _ = field.shape
    back = grid_coords_3d(d, h, w, dtype=field.dtype,
                          device=field.device) - dt * vel.flip(-1)
    return _corner_minmax(field, *_stencil_corners(back, (d, h, w)),
                          (d, h, w))
