"""Gaussian blur and blur + box-mean downsampling.

Counterpart of ``gaussian_blur_nd``, ``downsample_axis``, ``downsample_3d``
and ``downsample_2d`` in ``mpgan_tpu/ops/resample.py``: the tile creator
builds ``hrz``, the HR density downsampled along z only (the pass-1
target), and datagen the LR fields of each frame with them.

The blur is a sum of shifted copies of the edge-padded input weighted by
the 1-D Gaussian, in float32 on whatever device the tensor lies on — no
convolution library, so no TF32 demotion on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_nd(x: torch.Tensor, sigma: float,
                     axes: tuple[int, ...]) -> torch.Tensor:
    """Separable Gaussian blur along ``axes`` with edge-replicate padding,
    radius ⌈3σ⌉ (at least 1), accumulated in float32."""
    radius = max(1, int(np.ceil(3.0 * sigma)))
    k = _gauss_kernel1d(sigma, radius)
    for ax in axes:
        x = _conv1d_along(x, k, ax, radius)
    return x


def _conv1d_along(x: torch.Tensor, k: np.ndarray, axis: int,
                  radius: int) -> torch.Tensor:
    axis = axis % x.dim()
    n = x.shape[axis]
    src = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
    xp = x.to(torch.float32).index_select(axis, src)   # edge-replicate pad
    out = None
    for i, ki in enumerate(k):
        term = xp.narrow(axis, i, n) * float(ki)
        out = term if out is None else out + term
    return out.to(x.dtype)


def downsample_axis(vol: torch.Tensor, factor: int, axis: int,
                    blur_sigma: float | None = None) -> torch.Tensor:
    """Blur (σ = factor/2 unless given) and box-average along one axis.

    ``factor=1`` is the identity unless an explicit ``blur_sigma`` asks for
    a pure blur."""
    if factor == 1 and blur_sigma is None:
        return vol
    if blur_sigma is None:
        blur_sigma = factor / 2.0
    vol = gaussian_blur_nd(vol, blur_sigma, axes=(axis,))
    axis = axis % vol.dim()
    shape = vol.shape
    new = shape[:axis] + (shape[axis] // factor, factor) + shape[axis + 1:]
    return vol.reshape(new).mean(dim=axis + 1)


def downsample_3d(vol: torch.Tensor, factor: int,
                  blur_sigma: float | None = None) -> torch.Tensor:
    """(Z, Y, X, C) → (Z/f, Y/f, X/f, C): Gaussian blur then box-average,
    one axis after the other (the HR→LR step of datagen)."""
    for ax in (0, 1, 2):
        vol = downsample_axis(vol, factor, ax, blur_sigma)
    return vol


def downsample_2d(img: torch.Tensor, factor: int,
                  blur_sigma: float | None = None) -> torch.Tensor:
    """(H, W, C) → (H/f, W/f, C): Gaussian blur then box-average."""
    for ax in (0, 1):
        img = downsample_axis(img, factor, ax, blur_sigma)
    return img
