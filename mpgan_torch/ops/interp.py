"""Border-clamped bilinear sampling — the primitive under the semi-Lagrangian
warp. Counterpart of ``mpgan_tpu/ops/interp.py`` (the 2D half; the
trilinear sampler waits for the 3D warp).

Conventions as in the JAX package: batched fields ``(B, H, W, C)`` indexed
(y, x); coordinates are float cell-centre indices (0 = first cell centre)
given as (y, x) and clamped to the border. The JAX functions take one
field; these take a batch (the JAX callers ``vmap`` them).
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
