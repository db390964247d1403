"""Parameter initialisation as flax does it, for every conv and dense layer
of the port's generator and discriminators.

Flax's ``nn.Conv`` and ``nn.Dense`` default to ``lecun_normal`` kernels —
``jax.nn.initializers.variance_scaling(1.0, "fan_in", "truncated_normal")``:
a normal cut at ±2 standard deviations whose scale is divided by the std
of the cut unit normal (0.8796…), so that the variance after the cut is
1/fan_in — and to zero biases. PyTorch's defaults (Kaiming-uniform weights,
uniform biases) differ, so a port that trains from scratch would start from
another distribution than the JAX trainer.

Layers are built with ``torch.nn.utils.skip_init`` (no draw from the global
generator) and filled from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

# std of a unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``weight`` in place from a normal truncated at ±2σ, with
    σ = 1/(√fan_in · 0.8796), so that the variance after the cut is
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def conv2d(in_channels: int, out_channels: int, kernel_size: int,
           generator: torch.Generator, **kw) -> nn.Conv2d:
    """``nn.Conv2d`` with a lecun-normal kernel and a zero bias."""
    conv = nn.utils.skip_init(nn.Conv2d, in_channels, out_channels,
                              kernel_size, **kw)
    lecun_normal_(conv.weight, in_channels * kernel_size * kernel_size,
                  generator)
    nn.init.zeros_(conv.bias)
    return conv


def linear(in_features: int, out_features: int,
           generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with a lecun-normal kernel and a zero bias."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features)
    lecun_normal_(lin.weight, in_features, generator)
    nn.init.zeros_(lin.bias)
    return lin


def default_generator(generator: torch.Generator | None) -> torch.Generator:
    """The caller's generator, or a CPU one seeded with 0."""
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)
