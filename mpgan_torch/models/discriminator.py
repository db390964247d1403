"""Spatial (Ds) and temporal (Dt) discriminators.

Counterpart of ``mpgan_tpu/models/discriminator.py`` with flax's module
names (``from_in_{k}``, ``down_{k}``, ``conv_{k}``, ``out``), so converted
flax parameters load one to one (:mod:`mpgan_torch.convert`).

Ds is conditional: it scores an HR density patch given the LR input
(linearly upsampled and channel-concatenated, :func:`condition_ds_input`).
Dt is unconditional: it scores three advection-aligned HR density frames
stacked as channels. Both share a growing conv trunk: stage-k inputs enter
through a per-stage ``from_in`` head; during fade-in the newest block's
output is blended with the previous head applied to a downsampled input.

Differences from a naive translation, each held by a test:
- flax ``SAME`` padding of a strided 3×3 conv puts the odd pad after:
  on an even size with stride 2 it pads 0 before and 1 after, so the trunk
  pads explicitly (:func:`_pad_same`) and convolves with ``padding=0``;
- ``out`` is a Dense over the NHWC flatten of the last map, so the map is
  flattened in NHWC order and the flax kernel only transposes. Its input
  width depends on the input size, so the module is built for one input
  size (``in_hw``);
- ``jax.image.resize(..., "linear")`` antialiases when it downsamples; the
  port's :func:`downsample` is ``F.interpolate(..., antialias=True)``.

A model is built for one growth stage (``len(factors)`` stages, as the
flax tree at that stage), computes in ``dtype`` with float32 parameters,
and returns float32 logits (B, 1) and features (NHWC).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mpgan_torch.models import init
from mpgan_torch.ops.upsample import upsample_any


def downsample(x: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, H/fh, W/fw, C), "linear")`` of an NCHW
    tensor: an antialiased (triangle-filter) linear downsample."""
    if fh == 1 and fw == 1:
        return x
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h // fh, w // fw), mode="bilinear",
                         align_corners=False, antialias=True)


def downsample_nhwc(x: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """:func:`downsample` of an NHWC slice batch."""
    return downsample(x.permute(0, 3, 1, 2), fh, fw).permute(0, 2, 3, 1)


def _same_pads(n: int, stride: int, k: int = 3) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one axis: (before, after)."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, stride: tuple[int, int]) -> torch.Tensor:
    ph = _same_pads(x.shape[-2], stride[0])
    pw = _same_pads(x.shape[-1], stride[1])
    if ph == (1, 1) and pw == (1, 1):
        return x  # the conv pads symmetrically itself
    return F.pad(x, (*pw, *ph))


def _conv(conv: nn.Conv2d, x: torch.Tensor,
          stride: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """3×3 ``SAME`` conv with the float32 parameters cast to x's dtype."""
    padded = _pad_same(x, stride)
    return F.conv2d(padded, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    stride=stride, padding=1 if padded is x else 0)


class Discriminator(nn.Module):
    """Growing conv discriminator → (B, 1) float32 logits.

    in_channels: input channels (Ds: conditioning + 1; Dt: 3);
    in_hw: (H, W) of the inputs the model scores;
    factors: per-stage (fh, fw) downsample factors, outermost stage first;
    the model is built at stage ``len(factors)``.
    """

    def __init__(self, in_channels: int, in_hw: tuple[int, int],
                 factors: Sequence[tuple[int, int]] = ((2, 2), (2, 2)),
                 base_filters: int = 32, max_filters: int = 256,
                 min_filters: int = 8, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = init.default_generator(generator)
        self.factors = tuple(tuple(f) for f in factors)
        self.base_filters = base_filters
        self.max_filters = max_filters
        self.min_filters = min_filters
        self.dtype = dtype
        stage = len(self.factors)
        # module order as flax creates them: the input heads (outermost
        # first), then the trunk from the outermost stage inwards, then out
        for k in range(stage - 1, -1, -1):
            self.add_module(f"from_in_{k}", init.conv2d(
                in_channels, self._stage_filters(k + 1), 3, generator))
        h, w = in_hw
        for k in range(stage - 1, -1, -1):
            fh, fw = self.factors[k]
            width = self._stage_filters(k + 1)
            self.add_module(f"down_{k}", init.conv2d(
                width, self._stage_filters(k), 3, generator))
            self.add_module(f"conv_{k}", init.conv2d(
                self._stage_filters(k), self._stage_filters(k), 3, generator))
            h, w = math.ceil(h / fh), math.ceil(w / fw)
        self.out = init.linear(h * w * self._stage_filters(0), 1, generator)

    def _stage_filters(self, k: int) -> int:
        # stage k (0 = innermost/LR-side) gets wider filters
        return min(max(self.base_filters // (2 ** k), self.min_filters),
                   self.max_filters)

    def forward(self, x: torch.Tensor, alpha: float = 1.0,
                fade: bool = False, return_features: bool = False):
        """x (B, H, W, C) NHWC → logits (B, 1) float32 [, features: the
        output of every ``down_k`` and ``conv_k`` (after the fade blend),
        NHWC float32]."""
        stage = len(self.factors)
        x = x.to(self.dtype).permute(0, 3, 1, 2)

        def head(k, inp):
            return F.leaky_relu(_conv(getattr(self, f"from_in_{k}"), inp),
                                0.2)

        h = head(stage - 1, x)
        fading = stage > 1 and fade
        if fading:  # the previous stage's head on the downsampled input
            old = head(stage - 2, downsample(x, *self.factors[stage - 1]))
        feats = []
        for k in range(stage - 1, -1, -1):
            h = F.leaky_relu(_conv(getattr(self, f"down_{k}"), h,
                                   self.factors[k]), 0.2)
            feats.append(h)
            h = F.leaky_relu(_conv(getattr(self, f"conv_{k}"), h), 0.2)
            if k == stage - 1 and fading:
                # blend after the newest stage's whole block, so that at
                # alpha=0 the net is exactly the previous-stage D
                h = alpha * h + (1.0 - alpha) * old
            feats.append(h)

        flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC order
        logits = F.linear(flat, self.out.weight.to(flat.dtype),
                          self.out.bias.to(flat.dtype)).to(torch.float32)
        if return_features:
            return logits, [f.to(torch.float32).permute(0, 2, 3, 1)
                            for f in feats]
        return logits


def make_spatial(stage: int, in_channels: int, in_hw: tuple[int, int],
                 base_filters: int = 32,
                 factors: Sequence[tuple[int, int]] | None = None,
                 dtype=torch.float32,
                 generator: torch.Generator | None = None) -> Discriminator:
    """Ds at growth ``stage``: conditional — the caller concatenates
    [upsampled LR channels, HR patch] (:func:`condition_ds_input`)."""
    if factors is None:
        factors = tuple((2, 2) for _ in range(stage))
    return Discriminator(in_channels, in_hw, factors=tuple(factors)[:stage],
                         base_filters=base_filters, dtype=dtype,
                         generator=generator)


def make_temporal(stage: int, in_hw: tuple[int, int], base_filters: int = 32,
                  factors: Sequence[tuple[int, int]] | None = None,
                  dtype=torch.float32,
                  generator: torch.Generator | None = None) -> Discriminator:
    """Dt at growth ``stage``: unconditional — the caller stacks 3 aligned
    HR density frames as channels."""
    if factors is None:
        factors = tuple((2, 2) for _ in range(stage))
    return Discriminator(3, in_hw, factors=tuple(factors)[:stage],
                         base_filters=base_filters, dtype=dtype,
                         generator=generator)


def condition_ds_input(lr: torch.Tensor, hr: torch.Tensor,
                       fh: int, fw: int) -> torch.Tensor:
    """Ds input: the LR channels linearly upsampled to HR size, then the HR
    patch (NHWC)."""
    return torch.cat([upsample_any(lr, fh, fw), hr.to(lr.dtype)], dim=-1)
