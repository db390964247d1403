"""Semi-Lagrangian frame warping (plain PyTorch).

Counterpart of ``mpgan_tpu/ops/warp.py`` ``advect_2d`` / ``advect_2d_batch``:
for each target cell, sample the source field at the backtraced position
``x − dt·v(x)`` with border-clamped bilinear interpolation. Velocity
channels are (v_w, v_h) — x component first — and are reversed to (y, x)
coordinates. :func:`advect_3d` is the same warp in 3D, unclamped, with
trilinear taps (the temporal-coherence metric of :mod:`mpgan_torch.eval`).
MacCormack waits for datagen, its only user.

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
