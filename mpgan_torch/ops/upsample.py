"""Exact half-pixel, edge-clamped linear upsampling.

Counterpart of ``mpgan_tpu/ops/upsample.py`` and of ``jax.image.resize(...,
"linear")`` at integer upsampling factors. Output sample ``j`` of an
``s``-fold upsample reads input position ``(j + 0.5)/s − 0.5`` with two-tap
linear weights; a position past either edge reads the edge sample.
``F.interpolate(mode="bilinear"/"trilinear", align_corners=False)`` computes
exactly that: it clamps negative source positions to 0 and the upper tap
index to ``n − 1``, which equals resize's renormalised edge weights.

The one-shot ``s×`` upsample (the generator's global skip) is NOT iterated
2×: two 2× resizes and one 4× resize give different interior weights.

The JAX package's ``upsample_mode``/``skip_mode`` knobs choose among XLA
lowerings that are all numerically equal; the port computes one way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_nchw(x: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """One-shot ``(fh, fw)`` linear upsample of an NCHW tensor."""
    if fh == 1 and fw == 1:
        return x
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * fh, w * fw), mode="bilinear",
                         align_corners=False)


def upsample_2d(x: torch.Tensor, fh: int, fw: int,
                mode: str = "conv_dense") -> torch.Tensor:
    """Per-stage slice-batch upsample ``(B, H, W, C) -> (B, fh·H, fw·W, C)``.

    ``mode`` is accepted for parity with the JAX package and ignored: all of
    its modes compute the same values."""
    if fh not in (1, 2) or fw not in (1, 2):
        raise ValueError(f"per-stage factors are 1 or 2, got {(fh, fw)}")
    return upsample_any(x, fh, fw)


def upsample_any(x: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """One-shot ``(fh, fw)`` linear upsample of an NHWC slice batch."""
    return upsample_nchw(x.permute(0, 3, 1, 2), fh, fw).permute(0, 2, 3, 1)


def resize_volume(vol: torch.Tensor, shape: tuple[int, int, int]
                  ) -> torch.Tensor:
    """Linear resize of a ``(Z, Y, X, C)`` volume to ``shape`` = (Z', Y', X'),
    as ``jax.image.resize(vol, (*shape, C), "linear")`` at integer
    upsampling factors (an axis may keep its size)."""
    z, y, x, _ = vol.shape
    if shape[0] == z:
        # per-z-plane bilinear: (Z, C, Y, X) → (Z, C, Y', X')
        out = F.interpolate(vol.permute(0, 3, 1, 2), size=tuple(shape[1:]),
                            mode="bilinear", align_corners=False)
        return out.permute(0, 2, 3, 1)
    out = F.interpolate(vol.permute(3, 0, 1, 2)[None], size=tuple(shape),
                        mode="trilinear", align_corners=False)
    return out[0].permute(1, 2, 3, 0)
