"""Dataset file names and derived input channels, as the JAX loader has them.

A copy of the numpy-only parts of ``mpgan_tpu/data/loader.py`` that
inference reads: the per-frame ``.uni`` file patterns and the vorticity
channels. The port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

LOW_DENSITY = "density_low_%04d.uni"
LOW_VELOCITY = "velocity_low_%04d.uni"
HIGH_DENSITY = "density_high_%04d.uni"


def vorticity(vel: np.ndarray) -> np.ndarray:
    """Curl of a (Z, Y, X, 3) velocity field, central differences, LR units.

    Central differences in the interior, one-sided at the boundary planes
    (np.gradient): the solver domain is a closed box."""
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    wx = np.gradient(vz, axis=1) - np.gradient(vy, axis=0)  # 0=z, 1=y, 2=x
    wy = np.gradient(vx, axis=0) - np.gradient(vz, axis=2)
    wz = np.gradient(vy, axis=2) - np.gradient(vx, axis=1)
    return np.stack([wx, wy, wz], axis=-1).astype(np.float32)
