"""Host-side dataset assembly — a copy of ``mpgan_tpu/data/loader.py``.

Indexes ``<base>/sim_%04d/`` directories and loads per-frame LR/HR ``.uni``
volumes into dense numpy arrays, eagerly, into host RAM (``data_fraction``
bounds it); the tile creator then moves what a pass needs to the card
once. Decoding uses the port's pure-Python codec (:mod:`mpgan_torch.io.uni`).
The port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass

import numpy as np

from mpgan_torch.io import uni

LOW_DENSITY = "density_low_%04d.uni"
LOW_VELOCITY = "velocity_low_%04d.uni"
HIGH_DENSITY = "density_high_%04d.uni"
HIGH_VELOCITY = "velocity_high_%04d.uni"


@dataclass
class FluidDataset:
    """Dense LR/HR volume stacks.

    lr: (N, Z, Y, X, C)  — C = 1 (density), 4 (+ vx, vy, vz) or 7
        (+ vorticity)
    hr: (N, Z·s, Y·s, X·s, 1) — HR density
    n_sims, n_frames: N = n_sims · n_frames
    up_res: spatial factor s
    """
    lr: np.ndarray
    hr: np.ndarray
    n_sims: int
    n_frames: int
    up_res: int

    @property
    def use_velocities(self) -> bool:
        return self.lr.shape[-1] >= 4

    @property
    def use_vorticities(self) -> bool:
        return self.lr.shape[-1] >= 7


def vorticity(vel: np.ndarray) -> np.ndarray:
    """Curl of a (Z, Y, X, 3) velocity field, central differences, LR units.

    Central differences in the interior, one-sided at the boundary planes
    (np.gradient): the solver domain is a closed box."""
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    wx = np.gradient(vz, axis=1) - np.gradient(vy, axis=0)  # 0=z, 1=y, 2=x
    wy = np.gradient(vx, axis=0) - np.gradient(vz, axis=2)
    wz = np.gradient(vy, axis=2) - np.gradient(vx, axis=1)
    return np.stack([wx, wy, wz], axis=-1).astype(np.float32)


class FluidDataLoader:
    """Reference-shaped loader: ``FluidDataLoader(...).get()`` → FluidDataset."""

    def __init__(self, base_path: str, from_sim: int, to_sim: int,
                 frame_min: int = 0, frame_max: int = 120,
                 use_velocities: bool = True, data_fraction: float = 1.0,
                 use_vorticities: bool = False, mac_recenter: bool = False):
        self.base_path = base_path
        self.sims = list(range(from_sim, to_sim + 1))
        self.frame_min = frame_min
        self.frame_max = frame_max
        self.use_velocities = use_velocities
        self.use_vorticities = use_vorticities and use_velocities
        self.data_fraction = data_fraction
        self.mac_recenter = mac_recenter

    def _frames_for(self, sim_dir: str) -> list[int]:
        # keep only the first CONTIGUOUS run of frames in which every file
        # this load needs exists: the temporal-triplet sampler treats
        # adjacent array indices as adjacent sim frames (dt = 1), so a gap
        # (or a frame a datagen interrupt left half written) truncates
        patterns = [LOW_DENSITY, HIGH_DENSITY]
        if self.use_velocities:
            patterns.append(LOW_VELOCITY)
        frames: list[int] = []
        for f in range(self.frame_min, self.frame_max):
            if all(os.path.exists(os.path.join(sim_dir, p % f))
                   for p in patterns):
                frames.append(f)
            elif frames:
                warnings.warn(
                    f"{sim_dir}: frame {f} missing/incomplete after "
                    f"{len(frames)} contiguous frames — truncating this sim "
                    f"there to keep temporal adjacency (dt=1) intact")
                break
        if self.data_fraction < 1.0 and frames:
            # contiguous prefix, not strided (dt = 1 adjacency)
            keep = max(1, int(len(frames) * self.data_fraction))
            frames = frames[:keep]
        return frames

    def get(self) -> FluidDataset:
        """Load all sims/frames with the pure-Python ``.uni`` decoder."""
        per_sim: list[tuple[str, list[int]]] = []
        for sim in self.sims:
            sim_dir = os.path.join(self.base_path, f"sim_{sim:04d}")
            if not os.path.isdir(sim_dir):
                raise FileNotFoundError(f"missing sim dir {sim_dir}")
            frames = self._frames_for(sim_dir)
            if not frames:
                raise FileNotFoundError(f"no frames in {sim_dir}")
            per_sim.append((sim_dir, frames))
        # truncate every sim to the global minimum so N == n_sims·n_frames
        # (uneven counts would let temporal triplets cross sim boundaries)
        n_frames = min(len(fr) for _, fr in per_sim)
        d_paths, v_paths, h_paths = [], [], []
        for sim_dir, frames in per_sim:
            for f in frames[:n_frames]:
                d_paths.append(os.path.join(sim_dir, LOW_DENSITY % f))
                if self.use_velocities:
                    v_paths.append(os.path.join(sim_dir, LOW_VELOCITY % f))
                h_paths.append(os.path.join(sim_dir, HIGH_DENSITY % f))

        d_arrs = [uni.readUni(p)[1] for p in d_paths]
        # staggered MAC faces are averaged to cell centres only for files
        # whose header carries TypeMAC; cell-centred grids pass untouched
        v_arrs = [uni.readUni(p, recenter=self.mac_recenter)[1]
                  for p in v_paths]
        h_arrs = [uni.readUni(p)[1] for p in h_paths]
        if self.use_velocities:
            chans = [np.concatenate([d.astype(np.float32),
                                     v.astype(np.float32)], axis=-1)
                     for d, v in zip(d_arrs, v_arrs)]
            if self.use_vorticities:
                chans = [np.concatenate([c, vorticity(c[..., 1:4])], axis=-1)
                         for c in chans]
            lr = np.stack(chans)
        else:
            lr = np.stack([d.astype(np.float32) for d in d_arrs])
        hr = np.stack([h.astype(np.float32) for h in h_arrs])
        # infer the SR factor from Y (valid for 2D data too, where Z == 1)
        s = hr.shape[2] // lr.shape[2]
        return FluidDataset(lr=lr, hr=hr, n_sims=len(self.sims),
                            n_frames=n_frames, up_res=s)
