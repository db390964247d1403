"""Augmentation transforms and the velocity / vorticity channel transforms.

Counterpart of ``sample_transform``, ``transform_vectors`` and
``transform_pseudovectors`` in ``mpgan_tpu/ops/augment.py``. An output patch
pixel at offset p from the patch centre reads the source at ``c + A·p``
with ``A = R(θ)·diag(fy, fx)·σ`` in (y, x) space; velocity seen in output
coordinates is ``A⁻¹·v``. Both matrices are built analytically.

The transforms here are batched: ``ainv`` is (..., 2, 2) with the same
leading dims as the patch's (..., H, W, C) — one matrix per patch — or a
single (2, 2) matrix for one patch.
"""

from __future__ import annotations

import math

import torch

ROT_NONE = 0
ROT_90 = 1
ROT_FULL = 2


def sample_transform(generator: torch.Generator, rot_mode: int,
                     scale_min: float, scale_max: float, batch: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw ``batch`` transforms → (A, A⁻¹), each (batch, 2, 2) float32 on
    the generator's device: θ uniform in [0, 2π) (``rot_mode`` 2), a
    multiple of π/2 (1) or 0 (0); a flip of each axis with probability ½;
    σ uniform in [scale_min, scale_max)."""
    dev = generator.device
    if rot_mode == ROT_FULL:
        theta = torch.rand(batch, generator=generator, device=dev) * (
            2.0 * math.pi)
    elif rot_mode == ROT_90:
        theta = torch.randint(0, 4, (batch,), generator=generator,
                              device=dev).to(torch.float32) * (math.pi / 2)
    else:
        theta = torch.zeros(batch, device=dev)
    bits = torch.rand((batch, 2), generator=generator, device=dev) < 0.5
    fy = 1.0 - 2.0 * bits[:, 0].to(torch.float32)
    fx = 1.0 - 2.0 * bits[:, 1].to(torch.float32)
    sigma = scale_min + torch.rand(batch, generator=generator, device=dev) * (
        scale_max - scale_min)
    return transform_matrices(theta, fy, fx, sigma)


def transform_matrices(theta: torch.Tensor, fy: torch.Tensor,
                       fx: torch.Tensor, sigma: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, A⁻¹) for angles, axis flips (±1) and scales, each (B,):
    ``A = σ·[[c·fy, −s·fx], [s·fy, c·fx]]`` and
    ``A⁻¹ = [[c·fy, s·fy], [−s·fx, c·fx]]/σ``."""
    c, s = torch.cos(theta), torch.sin(theta)
    a = sigma[:, None, None] * torch.stack(
        [torch.stack([c * fy, -s * fx], -1),
         torch.stack([s * fy, c * fx], -1)], -2)
    ainv = torch.stack([torch.stack([c * fy, s * fy], -1),
                        torch.stack([-s * fx, c * fx], -1)], -2) / sigma[
        :, None, None]
    return a.to(torch.float32), ainv.to(torch.float32)


def _entry(m: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """``m[..., i, j]`` shaped to broadcast against (..., H, W)."""
    return m[..., i, j][..., None, None]


def transform_vectors(patch: torch.Tensor, ainv: torch.Tensor,
                      n_vel: int) -> torch.Tensor:
    """Apply the vector transform to velocity channels [1 : 1+n_vel];
    ``ainv`` acts in (y, x) space, channels are (vx, vy[, vz]). The
    out-of-plane component is scaled by √|det A⁻¹|."""
    if n_vel == 0:
        return patch
    dens = patch[..., :1]
    vx = patch[..., 1]
    vy = patch[..., 2]
    vy2 = _entry(ainv, 0, 0) * vy + _entry(ainv, 0, 1) * vx
    vx2 = _entry(ainv, 1, 0) * vy + _entry(ainv, 1, 1) * vx
    out = [dens, vx2[..., None], vy2[..., None]]
    if n_vel == 3:
        det = ainv[..., 0, 0] * ainv[..., 1, 1] - ainv[..., 0, 1] * ainv[
            ..., 1, 0]
        scale = torch.sqrt(torch.abs(det))[..., None, None, None]
        out.append(patch[..., 3:4] * scale)
        rest = patch[..., 4:]
    else:
        rest = patch[..., 1 + n_vel:]
    if rest.shape[-1]:
        out.append(rest)
    return torch.cat(out, dim=-1)


def transform_pseudovectors(patch: torch.Tensor, ainv: torch.Tensor,
                            start: int, n: int) -> torch.Tensor:
    """Transform vorticity-like channels [start : start+n] (pseudo-vectors):
    ``ω' = sign(det)·O·ω`` in-plane with the orthogonal part
    ``O = A⁻¹/√|det A⁻¹|``, and ``ω'_out = sign(det)·ω_out`` — the curl of
    the transformed velocity, which is scale-invariant and flips sign under
    reflection."""
    if n == 0:
        return patch
    det = ainv[..., 0, 0] * ainv[..., 1, 1] - ainv[..., 0, 1] * ainv[
        ..., 1, 0]
    sdet = torch.sign(det)[..., None, None]
    o = ainv / torch.sqrt(torch.abs(det))[..., None, None]
    wx = patch[..., start]
    wy = patch[..., start + 1]
    wy2 = sdet * (_entry(o, 0, 0) * wy + _entry(o, 0, 1) * wx)
    wx2 = sdet * (_entry(o, 1, 0) * wy + _entry(o, 1, 1) * wx)
    out = [patch[..., :start], wx2[..., None], wy2[..., None]]
    if n == 3:
        out.append(patch[..., start + 2:start + 3] * sdet[..., None])
        out.append(patch[..., start + 3:])
    else:
        out.append(patch[..., start + n:])
    return torch.cat(out, dim=-1)
