"""Multi-octave value noise for the smoke inflow — counterpart of
``mpgan_tpu/solver/noise.py``.

Each octave draws a coarse grid of uniform values and resizes it linearly
to the field: ``F.interpolate(mode="trilinear", align_corners=False)``,
which is ``jax.image.resize(method="linear")`` for every upsampling ratio
(half-pixel centres, edges clamped). The coarse grids come from an explicit
``torch.Generator`` on the field's device, or are injected (the tests feed
the JAX package's draws). JAX's threefry stream is not reproduced, so one
seed draws different noise in the two packages, from the same
distribution.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def coarse_shapes(shape: tuple[int, int, int], base_res: int = 4,
                  octaves: int = 3) -> list[tuple[int, int, int]]:
    """The coarse grid of each octave: (min(r, Z), min(r, Y), min(r, X))
    with r = base_res · 2^octave."""
    return [tuple(min(base_res * 2 ** o, n) for n in shape)
            for o in range(octaves)]


def value_noise_3d(shape: tuple[int, int, int], generator=None,
                   base_res: int = 4, octaves: int = 3,
                   persistence: float = 0.5, coarse=None,
                   device=None) -> torch.Tensor:
    """Smooth noise in [0, 1], shape (Z, Y, X), float32.

    The coarse grids are ``coarse`` (one per octave, shapes
    :func:`coarse_shapes`) when given, else drawn from ``generator`` on its
    device."""
    if coarse is None:
        device = generator.device if generator is not None else device
        coarse = [torch.rand(s, generator=generator, device=device)
                  for s in coarse_shapes(shape, base_res, octaves)]
    out, amp, total = None, 1.0, 0.0
    for c in coarse:
        c = torch.as_tensor(c, dtype=torch.float32, device=device)
        fine = F.interpolate(c[None, None], size=tuple(shape),
                             mode="trilinear", align_corners=False)[0, 0]
        out = amp * fine if out is None else out + amp * fine
        total += amp
        amp *= persistence
    return out / total


def frame_seed(seed: int, t: int) -> int:
    """The seed of frame ``t``'s noise: fresh and reproducible per (seed,
    frame index), as JAX's ``fold_in(key, t)`` makes it."""
    state = np.random.SeedSequence([seed, t]).generate_state(1, np.uint64)
    return int(state[0] >> 1)


def frame_generator(seed: int, t: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with :func:`frame_seed`. A graphed
    frame draws from one generator per sim instead, reseeded with the same
    seed before each frame (:mod:`mpgan_torch.solver.datagen`): it draws
    the same values."""
    return torch.Generator(device=device).manual_seed(frame_seed(seed, t))


def inflow_density(mask: torch.Tensor, generator=None, base_res: int = 4,
                   strength: float = 1.0, coarse=None) -> torch.Tensor:
    """(Z, Y, X, 1) noise-modulated inflow density over ``mask``, the
    octaves' grids drawn from ``generator`` (or injected as ``coarse``)."""
    z, y, x, _ = mask.shape
    n = value_noise_3d((z, y, x), generator, base_res=base_res, coarse=coarse,
                       device=mask.device)
    n = 0.5 + 0.5 * n  # keep the source dense
    return (strength * n)[..., None] * mask


def time_varying_inflow(seed: int, mask: torch.Tensor, t: int,
                        base_res: int = 4, strength: float = 1.0,
                        coarse=None) -> torch.Tensor:
    """The inflow density of frame ``t``: fresh noise per frame keeps the
    plume from being a steady column. ``coarse`` injects the octaves' grids
    (else drawn from :func:`frame_generator`)."""
    gen = (frame_generator(seed, t, mask.device) if coarse is None
           else None)
    return inflow_density(mask, gen, base_res, strength, coarse)
