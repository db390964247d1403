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

Its backward is not ``F.interpolate``'s: on CUDA that one scatters with
atomics, so a training run does not reproduce bit for bit. The reference
computes the upsample as a fixed-weight convolution whose backward is a
convolution too (``linear_up2_conv``, ``linear_up_conv``);
:class:`_Upsample` gives the forward its exact adjoint as slice-and-add
arithmetic along each axis, which sums every gradient in one fixed order.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _adjoint_weights(s: int, device: torch.device, dtype: torch.dtype
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(near, far) tap weights of the ``s`` output phases: phase ``r`` of
    input sample ``i`` reads position ``i + d``, ``d = (r + 0.5)/s − 0.5``,
    with weight ``1 − |d|`` on ``i`` and ``|d|`` on ``i + sign(d)``. Made
    once per device: a per-call host→device copy would synchronise."""
    d = [(r + 0.5) / s - 0.5 for r in range(s)]
    return (torch.tensor([1.0 - abs(v) for v in d], dtype=dtype,
                         device=device),
            torch.tensor([abs(v) for v in d], dtype=dtype, device=device))


def _adjoint_axis(g: torch.Tensor, s: int, dim: int) -> torch.Tensor:
    """The adjoint of the ``s``-fold half-pixel, edge-clamped linear
    upsample along ``dim`` (size n·s → n), in a fixed order: each output
    phase's near tap lands on its own sample and its far tap one sample
    up (d > 0) or down (d < 0); a far tap past an edge folds onto the edge
    sample, as the forward clamps it."""
    if s == 1:
        return g
    n = g.shape[dim] // s
    gv = g.unflatten(dim, (n, s))
    near_w, far_w = _adjoint_weights(s, g.device, g.dtype)
    shape = [1] * gv.dim()
    shape[dim + 1] = s
    out = (gv * near_w.view(shape)).sum(dim + 1)
    far = gv * far_w.view(shape)
    # phases r < s/2 read down (d < 0), the rest up (d ≥ 0)
    down = far.narrow(dim + 1, 0, s // 2).sum(dim + 1)
    up = far.narrow(dim + 1, s // 2, s - s // 2).sum(dim + 1)
    out.narrow(dim, 1, n - 1).add_(up.narrow(dim, 0, n - 1))
    out.narrow(dim, n - 1, 1).add_(up.narrow(dim, n - 1, 1))
    out.narrow(dim, 0, n - 1).add_(down.narrow(dim, 1, n - 1))
    out.narrow(dim, 0, 1).add_(down.narrow(dim, 0, 1))
    return out


class _Upsample(torch.autograd.Function):
    """``F.interpolate`` forward; the fixed-order adjoint backward (float32
    sums for half-precision gradients). The backward is made of
    differentiable ops, so a double backward goes through it."""

    @staticmethod
    def forward(ctx, x, fh, fw):
        ctx.factors = (fh, fw)
        h, w = x.shape[-2:]
        return F.interpolate(x, size=(h * fh, w * fw), mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        fh, fw = ctx.factors
        acc = (torch.float32 if g.dtype in (torch.float16, torch.bfloat16)
               else g.dtype)
        gx = _adjoint_axis(_adjoint_axis(g.to(acc), fw, 3), fh, 2)
        return gx.to(g.dtype), None, None


def upsample_nchw(x: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """One-shot ``(fh, fw)`` linear upsample of an NCHW tensor, with the
    fixed-order backward."""
    if fh == 1 and fw == 1:
        return x
    return _Upsample.apply(x, fh, fw)


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
