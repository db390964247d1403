"""Growing slice generator — pass-1 (xy), pass-2 (z refinement), pass-3 (yz).

Counterpart of ``mpgan_tpu/models/generator.py`` with the same module names
(``stem``, ``block_{k}_{i}.conv1/conv2/proj``, ``head_{k}``), so converted
flax parameters load one to one (:mod:`mpgan_torch.convert`).

A stem 3×3 conv, then per growth stage an upsample (per-axis factors 1 or
2) and residual blocks, with a per-stage output head. Fade-in blends
``α·head_k + (1−α)·up(head_{k−1})``; the global skip adds the one-shot
linearly upsampled input density (channel 0) at the product factor.

Numerics as in flax's ``nn.Conv(dtype=...)``: parameters are float32 and
are cast to ``dtype`` for the computation, which runs in ``dtype``; the
output is cast to ``out_dtype`` (float32 when None). Public layout is NHWC.
A fresh model is initialised as flax does it
(:mod:`mpgan_torch.models.init`), from an explicit ``torch.Generator``.

Two forwards compute the same function (:meth:`Generator.forward` picks,
by the rule written there): cuDNN's convolutions over NCHW views with
ATen's bias, ReLU and residual adds, each result rounded to ``dtype``
(training, float32, the CPU); and :meth:`Generator.forward_nhwc`, the
hand-written NHWC kernels of :mod:`mpgan_torch.ops.conv_kernel` with the
bias, ReLU, residual sum and global skip in their epilogues, rounded once
per convolution (bf16 inference on a card). ``nhwc_forwards`` and
``cudnn_forwards`` count the forwards each path ran (a captured program
counts once, at its capture).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mpgan_torch.models import init
from mpgan_torch.models.growing import fade_blend
from mpgan_torch.ops import conv_kernel
from mpgan_torch.ops.upsample import upsample_nchw

# forwards run by each path since the last reset (Generator.forward)
nhwc_forwards = 0
cudnn_forwards = 0


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` with its float32 parameters cast to the activation dtype."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                    padding=conv.padding)


class ResBlock(nn.Module):
    """Two 3×3 convs with a residual connection; a 1×1 ``proj`` exists only
    when the channel count changes."""

    def __init__(self, in_filters: int, filters: int,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = init.conv2d(in_filters, filters, 3, generator, padding=1)
        self.conv2 = init.conv2d(filters, filters, 3, generator, padding=1)
        self.proj = (init.conv2d(in_filters, filters, 1, generator)
                     if in_filters != filters else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv(self.conv2, F.relu(_conv(self.conv1, x)))
        if self.proj is not None:
            x = _conv(self.proj, x)
        return F.relu(x + h)


class Generator(nn.Module):
    """Stage-parameterized SR generator over a batch of slices.

    Call: ``(B, H, W, C_in) → (B, H·Πfh, W·Πfw, out_channels)`` for the
    first ``stage`` stages. ``upsample_mode``/``skip_mode`` are the JAX
    package's lowering knobs; they are accepted and change nothing here.
    ``generator`` draws the initial weights (a CPU generator seeded with 0
    when None).
    """

    def __init__(self, in_channels: int,
                 factors: Sequence[tuple[int, int]] = ((2, 2), (2, 2)),
                 base_filters: int = 32, min_filters: int = 8,
                 n_res_blocks: int = 2, out_channels: int = 1,
                 global_skip: bool = True,
                 dtype: torch.dtype = torch.float32,
                 out_dtype: torch.dtype | None = None,
                 remat: bool = False, upsample_mode: str = "conv_dense",
                 skip_mode: str = "resize",
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = init.default_generator(generator)
        self.factors = tuple(tuple(f) for f in factors)
        self.n_res_blocks = n_res_blocks
        self.global_skip = global_skip
        self.dtype = dtype
        self.out_dtype = out_dtype
        self.remat = remat
        self.stem = init.conv2d(in_channels, base_filters, 3, generator,
                                padding=1)
        width = base_filters
        for k in range(len(self.factors)):
            filters = max(base_filters // (2 ** (k + 1)), min_filters)
            for i in range(n_res_blocks):
                self.add_module(f"block_{k}_{i}",
                                ResBlock(width, filters, generator))
                width = filters
            self.add_module(f"head_{k}", init.conv2d(
                width, out_channels, 3, generator, padding=1))
        self.nhwc_widths = self._kernel_widths()

    def _kernel_widths(self) -> bool:
        """Whether every convolution has an NHWC kernel: the stem and each
        ``conv1`` in :data:`~mpgan_torch.ops.conv_kernel.RELU`, each
        ``conv2`` with its skip in ``RESIDUAL``, each head in ``HEAD``
        with one output channel; the first ResBlock of a stage that
        upsamples, which reads the stage input upsampled, in ``RELU_UP``
        and ``RESIDUAL_UP`` at one of ``UP_FACTORS``."""
        ck = conv_kernel
        if (self.stem.in_channels, self.stem.out_channels) not in ck.RELU:
            return False
        for k, up in enumerate(self.factors):
            if up != (1, 1) and (up not in ck.UP_FACTORS
                                 or self.n_res_blocks < 1):
                return False
            for i in range(self.n_res_blocks):
                block = getattr(self, f"block_{k}_{i}")
                cin, c = block.conv1.in_channels, block.conv1.out_channels
                relu, res = ((ck.RELU_UP, ck.RESIDUAL_UP)
                             if i == 0 and up != (1, 1)
                             else (ck.RELU, ck.RESIDUAL))
                if (cin, c) not in relu or (c, cin) not in res:
                    return False
            head = getattr(self, f"head_{k}")
            if head.out_channels != 1 or (
                    head.in_channels not in conv_kernel.HEAD):
                return False
        return True

    def _product(self, stage: int) -> tuple[int, int]:
        fh = fw = 1
        for a, b in self.factors[:stage]:
            fh *= a
            fw *= b
        return fh, fw

    def takes_nhwc(self, x: torch.Tensor, fade: bool = False) -> bool:
        """The path rule, from what the call shows: bf16 inference on a
        card with widths the kernels take runs the NHWC kernels, whose
        epilogues hold the bias, ReLU and residual sum (no layout copies,
        one rounding per conv). Everything else keeps cuDNN over NCHW
        views: training under grad or no_grad (its deterministic cuDNN
        kernels and the rounding its limits were set on), a fade-in (the
        trainer's alone), float32, the CPU and widths without a kernel
        (a 7-channel stem)."""
        return bool(x.is_cuda and self.dtype == torch.bfloat16
                    and torch.is_inference_mode_enabled() and not fade
                    and self.nhwc_widths)

    def forward(self, x: torch.Tensor, stage: int | None = None,
                alpha: float | torch.Tensor = 1.0,
                fade: bool = False) -> torch.Tensor:
        """``alpha``: the fade weight, a float or a 0-d float64 tensor
        (:func:`mpgan_torch.models.growing.fade_blend`)."""
        global nhwc_forwards, cudnn_forwards
        n_stages = len(self.factors)
        if stage is None:
            stage = n_stages
        if not 1 <= stage <= n_stages:
            raise ValueError(f"stage {stage} not in [1, {n_stages}]")
        if self.takes_nhwc(x, fade):
            nhwc_forwards += 1
            return self.forward_nhwc(x, stage)
        cudnn_forwards += 1
        # NHWC → NCHW view, no copy; channels_last storage measured slower
        # through cuDNN on an H100 (PERF.md, Findings)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        dens_in = x[:, 0:1]
        h = F.relu(_conv(self.stem, x))

        heads = []
        for k in range(stage):
            h = upsample_nchw(h, *self.factors[k])
            for i in range(self.n_res_blocks):
                block = getattr(self, f"block_{k}_{i}")
                if self.remat and torch.is_grad_enabled():
                    # the blocks draw no random numbers, so there is no
                    # RNG state to stash (reading it is refused while a
                    # CUDA graph captures)
                    h = checkpoint(block, h, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    h = block(h)
            heads.append(_conv(getattr(self, f"head_{k}"), h))

        out = heads[stage - 1]
        if stage > 1 and fade:
            out = fade_blend(alpha, out, upsample_nchw(
                heads[stage - 2], *self.factors[stage - 1]))

        if self.global_skip:
            out = out + upsample_nchw(dens_in, *self._product(stage))
        return out.to(self.out_dtype or torch.float32).permute(0, 2, 3, 1)

    def forward_nhwc(self, x: torch.Tensor, stage: int) -> torch.Tensor:
        """The forward over NHWC activations through
        :mod:`mpgan_torch.ops.conv_kernel` (kernels for CUDA tensors, their
        plain versions for CPU ones): the stem, per stage the ResBlocks,
        two launches each, the first of a stage reading the stage input
        upsampled by the stage's factors in both of its launches (the
        upsampled tensor is never made), then only the head whose output
        is used, with the global skip in its epilogue. ``x`` is read at its
        strides."""
        x = x.to(self.dtype)
        dens = x[..., 0:1] if self.global_skip else None
        h = conv_kernel.conv_relu(x, self.stem)
        for k in range(stage):
            up = self.factors[k]
            for i in range(self.n_res_blocks):
                block = getattr(self, f"block_{k}_{i}")
                h = conv_kernel.conv_residual(
                    conv_kernel.conv_relu(h, block.conv1, up=up),
                    block.conv2, h, block.proj, up=up)
                up = (1, 1)
        return conv_kernel.conv_head(
            h, getattr(self, f"head_{stage - 1}"), dens,
            self._product(stage), self.out_dtype or torch.float32)


def make_pass1(stages: int, base_filters: int = 32, n_res_blocks: int = 2,
               dtype=torch.float32, remat: bool = False, out_dtype=None,
               in_channels: int = 4, skip_mode: str = "resize",
               generator: torch.Generator | None = None) -> Generator:
    """Pass-1 generator: isotropic in-plane 2× per stage (2^stages total)."""
    return Generator(in_channels, factors=tuple((2, 2) for _ in range(stages)),
                     base_filters=base_filters, n_res_blocks=n_res_blocks,
                     dtype=dtype, remat=remat, out_dtype=out_dtype,
                     skip_mode=skip_mode, generator=generator)


def make_pass2(stages: int, base_filters: int = 32, n_res_blocks: int = 2,
               dtype=torch.float32, remat: bool = False, out_dtype=None,
               in_channels: int = 4, skip_mode: str = "resize",
               generator: torch.Generator | None = None) -> Generator:
    """Pass-2 generator: z-only (h-axis) 2× per stage; w axis already HR."""
    return Generator(in_channels, factors=tuple((2, 1) for _ in range(stages)),
                     base_filters=base_filters, n_res_blocks=n_res_blocks,
                     dtype=dtype, remat=remat, out_dtype=out_dtype,
                     skip_mode=skip_mode, generator=generator)


def make_pass3(base_filters: int = 32, n_res_blocks: int = 2,
               dtype=torch.float32, remat: bool = False, out_dtype=None,
               in_channels: int = 4,
               generator: torch.Generator | None = None) -> Generator:
    """Optional pass-3 refiner: constant resolution (factors (1,1)) over yz
    slices of the full-res volume."""
    return Generator(in_channels, factors=((1, 1),),
                     base_filters=base_filters, n_res_blocks=n_res_blocks,
                     dtype=dtype, remat=remat, out_dtype=out_dtype,
                     generator=generator)
