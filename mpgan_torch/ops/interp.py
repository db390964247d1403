"""Border-clamped bilinear and trilinear sampling — the primitives under
the semi-Lagrangian warp and the tile creator's patch gathers. Counterpart
of ``mpgan_tpu/ops/interp.py``.

Conventions as in the JAX package: batched fields ``(B, H, W, C)`` indexed
(y, x), volumes ``(Z, Y, X, C)`` indexed (z, y, x); coordinates are float
cell-centre indices (0 = first cell centre), clamped to the border. The JAX
2D sampler takes one field and its callers ``vmap`` it; the port's takes a
batch. The port has no ``vmap``, so :func:`trilinear_sample_stack` gathers
from a stack of volumes with a volume index per sample.
"""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` (B, H, W, C) at float coords (B, ..., 2) given as (y, x).

    Border-clamped bilinear interpolation. Returns (B, ..., C).
    """
    b, h, w, c = img.shape
    y = coords[..., 0].clamp(0.0, h - 1.0)
    x = coords[..., 1].clamp(0.0, w - 1.0)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    fy = (y - y0.to(y.dtype))[..., None]
    fx = (x - x0.to(x.dtype))[..., None]

    flat = img.reshape(b, h * w, c)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*yy.shape, c)

    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def grid_coords_2d(h: int, w: int, dtype=torch.float32,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """(H, W, 2) tensor of (y, x) cell-centre indices."""
    yy = torch.arange(h, dtype=dtype, device=device)[:, None]
    xx = torch.arange(w, dtype=dtype, device=device)[None, :]
    return torch.stack(torch.broadcast_tensors(yy, xx), dim=-1)


def trilinear_sample(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``vol`` (Z, Y, X, C) at float coords (..., 3) given as (z, y, x).

    Border-clamped trilinear interpolation. Returns (..., C).
    """
    return trilinear_sample_stack(vol[None], None, coords)


def trilinear_sample_stack(vols: torch.Tensor, vol_idx: torch.Tensor | None,
                           coords: torch.Tensor) -> torch.Tensor:
    """Sample the stack ``vols`` (N, Z, Y, X, C) at coords (B, ..., 3) as
    (z, y, x), sample ``b`` from volume ``vol_idx[b]`` (from volume 0 when
    ``vol_idx`` is None). Border-clamped trilinear. Returns (B, ..., C).

    One gather fetches all eight corners; the blend is the JAX sampler's,
    term for term.
    """
    _, d, h, w, c = vols.shape
    z = coords[..., 0].clamp(0.0, d - 1.0)
    y = coords[..., 1].clamp(0.0, h - 1.0)
    x = coords[..., 2].clamp(0.0, w - 1.0)
    z0 = torch.floor(z).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x0 = torch.floor(x).to(torch.int64)
    z1 = (z0 + 1).clamp(max=d - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    fz = (z - z0.to(z.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    fx = (x - x0.to(x.dtype))[..., None]

    base = 0
    if vol_idx is not None:
        base = (vol_idx.to(torch.int64) * (d * h * w)).reshape(
            (-1,) + (1,) * (coords.dim() - 2))
    zs = (z0 * h, z1 * h)
    ys = (y0, y1)
    xs = (x0, x1)
    # corner order (z, y, x) ∈ {0,1}³, z slowest
    idx = torch.stack([base + (zz + yy) * w + xx
                       for zz in zs for yy in ys for xx in xs])
    corners = vols.reshape(-1, c).index_select(0, idx.reshape(-1))
    v = corners.reshape(*idx.shape, c)

    c00 = v[0] * (1 - fx) + v[1] * fx
    c01 = v[2] * (1 - fx) + v[3] * fx
    c10 = v[4] * (1 - fx) + v[5] * fx
    c11 = v[6] * (1 - fx) + v[7] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def grid_coords_3d(d: int, h: int, w: int, dtype=torch.float32,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """(Z, Y, X, 3) tensor of (z, y, x) cell-centre indices."""
    zz = torch.arange(d, dtype=dtype, device=device)[:, None, None]
    yy = torch.arange(h, dtype=dtype, device=device)[None, :, None]
    xx = torch.arange(w, dtype=dtype, device=device)[None, None, :]
    return torch.stack(torch.broadcast_tensors(zz, yy, xx), dim=-1)
