"""Device-side tile creator — counterpart of ``mpgan_tpu/data/pipeline.py``.

A training batch is a set of coordinate grids in LR physical space,
rotated / flipped / scaled by the augmentation transform and gathered from
the resident volumes by trilinear interpolation (one resampling step),
with velocity channels multiplied by the inverse Jacobian. Everything per
batch runs on the tile creator's device.

Each sampler is split in two:
- *draw* (:func:`draw`): an explicit ``torch.Generator`` yields the dense
  cells picked, their jitter and the transforms (:class:`Draws`);
- *assemble* (:func:`assemble_pass1`, :func:`assemble_pass2`): a pure
  function of the volumes and the draws.
Tests inject draws into the second half; the JAX package's random bits
cannot be reproduced here.

Plane conventions (multi-pass slicing): 'xy' (pass 1): h = y, w = x, slice
normal z; 'xz' (pass 2): h = z, w = x, normal y; 'yz': h = y, w = z,
normal x. Gathered velocity channels are permuted to the per-plane layout
``[density, v_w, v_h, v_out]``.

Sources: ``lr`` (N, Z, Y, X, C) LR volumes; ``hrz`` (N, Z, Y·s, X·s, 1) HR
density downsampled along z only (the pass-1 target and pass-2 input);
``hr`` (N, Z·s, Y·s, X·s, 1) full HR density (the pass-2 target).
Residency is lazy and per pass: pass 1 puts only ``lr`` and ``hrz`` on the
device, and ``hrz`` is built one HR volume at a time. Sharded residency and
pass 3 are not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from mpgan_torch.data.loader import FluidDataset
from mpgan_torch.device import resolve_device
from mpgan_torch.ops.augment import (sample_transform, transform_pseudovectors,
                                     transform_vectors)
from mpgan_torch.ops.interp import trilinear_sample_stack
from mpgan_torch.ops.resample import downsample_axis

PLANES = ("xy", "xz", "yz")
# channel permutation [d, vx, vy, vz] → [d, v_w, v_h, v_out] per plane
_VEL_PERM = {"xy": (0, 1, 2, 3), "xz": (0, 1, 3, 2), "yz": (0, 3, 2, 1)}
# (h, w, normal) → volume axes (0=z, 1=y, 2=x)
_PLANE_AXES = {"xy": (1, 2, 0), "xz": (0, 2, 1), "yz": (1, 0, 2)}


class TCStatic(NamedTuple):
    """Static sampling configuration."""
    tile_lr: int
    up_res: int
    n_vel: int
    n_vort: int
    n_frames: int
    n_vols: int
    augment: bool
    rot_mode: int
    scale_min: float
    scale_max: float
    dims_zyx: tuple[int, int, int]
    pool_zyx: tuple[int, int, int]


class Draws(NamedTuple):
    """The random part of one batch, all on the sampling device.

    pick (B,) int64: rows of the dense-cell index; jitter (B, 3) float32:
    uniform [0, 1) position inside the pooled cell (scaled by the pool at
    assembly); a, ainv (B, 2, 2) float32: the augmentation transforms."""
    pick: torch.Tensor
    jitter: torch.Tensor
    a: torch.Tensor
    ainv: torch.Tensor


@functools.lru_cache(maxsize=64)
def _const(values: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small float32 constant on ``device``, made once: building it per
    batch would be a host→device copy, which synchronises the stream.
    Callers must not write to it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def plane_patch_coords(plane: str, center_zyx: torch.Tensor, a: torch.Tensor,
                       h: int, w: int, spacing_h: float,
                       spacing_w: float) -> torch.Tensor:
    """(B, h, w, 3) grids of (z, y, x) coords in LR space, one per centre
    (B, 3) and transform ``a`` (B, 2, 2) acting on (h, w) offsets; spacing
    is LR cells per output pixel (1 for LR tiles, 1/s for HR tiles)."""
    dev = center_zyx.device
    off_h = (torch.arange(h, dtype=torch.float32, device=dev)
             - (h - 1) / 2.0) * spacing_h
    off_w = (torch.arange(w, dtype=torch.float32, device=dev)
             - (w - 1) / 2.0) * spacing_w
    dh, dw = torch.broadcast_tensors(off_h[:, None], off_w[None, :])
    rh = a[:, 0, 0, None, None] * dh + a[:, 0, 1, None, None] * dw
    rw = a[:, 1, 0, None, None] * dh + a[:, 1, 1, None, None] * dw
    ax_h, ax_w, _ = _PLANE_AXES[plane]
    comps = []
    for ax in range(3):
        c = center_zyx[:, ax, None, None].expand(-1, h, w)
        if ax == ax_h:
            c = c + rh
        elif ax == ax_w:
            c = c + rw
        comps.append(c)
    return torch.stack(comps, dim=-1)


def gather_patch(vols: torch.Tensor, vol_idx: torch.Tensor,
                 coords_lr: torch.Tensor,
                 scale_zyx: tuple[float, float, float]) -> torch.Tensor:
    """Trilinear-gather patches from ``vols[vol_idx]`` at LR-space coords;
    ``scale_zyx`` maps LR coords to this stack's index space:
    idx = (c + 0.5)·scale − 0.5."""
    s = _const(tuple(scale_zyx), coords_lr.device)
    return trilinear_sample_stack(vols, vol_idx, (coords_lr + 0.5) * s - 0.5)


def _permute_channels(patch: torch.Tensor, plane: str, n_vel: int,
                      n_vort: int = 0) -> torch.Tensor:
    """Reorder [d, vx, vy, vz(, wx, wy, wz)] → per-plane [d, v_w, v_h, v_out
    (, w_w, w_h, w_out)]; vorticity channels use the same permutation."""
    if n_vel == 0:
        return patch
    perm = _VEL_PERM[plane]
    chans = [patch[..., perm[0]:perm[0] + 1]]
    for c in perm[1:4]:
        chans.append(patch[..., c:c + 1])
    if n_vort:
        for c in perm[1:4]:
            chans.append(patch[..., c + 3:c + 4])
        rest = patch[..., 7:]
    else:
        rest = patch[..., 4:]
    if rest.shape[-1]:
        chans.append(rest)
    return torch.cat(chans, dim=-1)


def _margin(st: TCStatic) -> float:
    m = (st.tile_lr - 1) / 2.0 * (st.scale_max if st.augment else 1.0)
    if st.augment and st.rot_mode == 2:
        m *= float(np.sqrt(2.0))
    return float(m + 1.0)


def _candidates(pick: torch.Tensor, jitter: torch.Tensor, plane: str,
                dense_idx: torch.Tensor, st: TCStatic,
                normal_hr: bool = False):
    """(vol, centre_zyx) of the picked dense cells: jitter inside the pooled
    cell, the in-plane axes clipped to the margin and snapped to the
    half-integer lattice, the slice normal on the LR lattice (on the HR
    lattice for ``normal_hr``, as pass 2 slices at HR-spaced positions)."""
    m = _margin(st)
    _, _, ax_n = _PLANE_AXES[plane]
    dims = st.dims_zyx
    half = (st.tile_lr - 1) / 2.0
    cells = dense_idx[pick]
    vol = cells[:, 0]
    pool = _const(tuple(float(p) for p in st.pool_zyx), pick.device)
    raw = cells[:, 1:4].to(torch.float32) * pool + jitter * pool

    def coord(axis):
        size = dims[axis]
        c = raw[:, axis]
        if axis == ax_n:  # slice normal: lattice position, no margin
            if normal_hr:
                j = torch.round((c + 0.5) * st.up_res - 0.5)
                j = j.clamp(0, size * st.up_res - 1)
                return (j + 0.5) / st.up_res - 0.5
            return torch.round(c).clamp(0, size - 1)
        lo, hi = m, max(size - 1 - m, m)
        c = c.clamp(lo, hi)
        # snap to the half-integer lattice so that, without rotation or
        # scale, LR patch pixels land on cells (and HR pixels on HR cells)
        return torch.floor(c - half) + half

    return vol, torch.stack([coord(0), coord(1), coord(2)], dim=-1)


def draw(generator: torch.Generator, batch: int, dense_idx: torch.Tensor,
         st: TCStatic) -> Draws:
    """The random part of a batch: ``batch`` rows of ``dense_idx``, their
    jitter, and the transforms (identity without augmentation)."""
    dev = generator.device
    pick = torch.randint(0, dense_idx.shape[0], (batch,), generator=generator,
                         device=dev)
    jitter = torch.rand((batch, 3), generator=generator, device=dev)
    if st.augment:
        a, ainv = sample_transform(generator, st.rot_mode, st.scale_min,
                                   st.scale_max, batch)
    else:
        a = ainv = torch.eye(2, device=dev).expand(batch, 2, 2)
    return Draws(pick, jitter, a, ainv)


def _with_neighbours(vol, centers, a, ainv, temporal: bool):
    """Stack the batch for volumes v (and v−1, v+1 when temporal) so one
    gather serves all three frames."""
    if not temporal:
        return vol, centers, a, ainv
    return (torch.cat([vol, vol - 1, vol + 1]), centers.repeat(3, 1),
            a.repeat(3, 1, 1), ainv.repeat(3, 1, 1))


def _split(out: dict, temporal: bool, batch: int) -> dict:
    """Undo :func:`_with_neighbours`: ``k`` (centre), ``k_prev``, ``k_next``."""
    if not temporal:
        return out
    res = {}
    for k, v in out.items():
        cur, prev, nxt = v.split(batch)
        res[k], res[f"{k}_prev"], res[f"{k}_next"] = cur, prev, nxt
    return res


def assemble_pass1(lr: torch.Tensor, hrz: torch.Tensor,
                   dense_idx: torch.Tensor, draws: Draws, plane: str,
                   temporal: bool, st: TCStatic) -> dict:
    """Pass-1 batch from drawn values: {'lr' (B,t,t,C), 'hr' (B,ts,ts,1)}
    [+ '_prev'/'_next' from volumes v∓1 at the same place]."""
    vol, centers = _candidates(draws.pick, draws.jitter, plane, dense_idx, st)
    b = vol.shape[0]
    vol, centers, a, ainv = _with_neighbours(vol, centers, draws.a,
                                             draws.ainv, temporal)
    t, s = st.tile_lr, st.up_res
    clr = plane_patch_coords(plane, centers, a, t, t, 1.0, 1.0)
    lrp = gather_patch(lr, vol, clr, (1.0, 1.0, 1.0))
    lrp = transform_vectors(
        _permute_channels(lrp, plane, st.n_vel, st.n_vort), ainv, st.n_vel)
    if st.n_vort:
        lrp = transform_pseudovectors(lrp, ainv, start=4, n=st.n_vort)
    chr_ = plane_patch_coords(plane, centers, a, t * s, t * s, 1.0 / s,
                              1.0 / s)
    hrp = gather_patch(hrz, vol, chr_, (1.0, float(s), float(s)))
    return _split({"lr": lrp, "hr": hrp}, temporal, b)


def assemble_pass2(lr: torch.Tensor, interm_src: torch.Tensor,
                   hr: torch.Tensor, dense_idx: torch.Tensor, draws: Draws,
                   plane: str, temporal: bool, st: TCStatic) -> dict:
    """Pass-2 batch from drawn values: {'interm' (B,t,ts,1), 'lr_vel'
    (B,t,ts,3), 'hr' (B,ts,ts,1)} [+ '_prev'/'_next']."""
    vol, centers = _candidates(draws.pick, draws.jitter, plane, dense_idx, st,
                               normal_hr=True)
    b = vol.shape[0]
    vol, centers, a, ainv = _with_neighbours(vol, centers, draws.a,
                                             draws.ainv, temporal)
    t, s = st.tile_lr, st.up_res
    # input: h = z at LR spacing (t px), w = x at HR spacing (t·s px)
    cin = plane_patch_coords(plane, centers, a, t, t * s, 1.0, 1.0 / s)
    out = {"interm": gather_patch(interm_src, vol, cin,
                                  (1.0, float(s), float(s)))}
    if st.n_vel:
        lrp = gather_patch(lr, vol, cin, (1.0, 1.0, 1.0))
        lrp = transform_vectors(_permute_channels(lrp, plane, st.n_vel),
                                ainv, st.n_vel)
        out["lr_vel"] = lrp[..., 1:4]
    cout = plane_patch_coords(plane, centers, a, t * s, t * s, 1.0 / s,
                              1.0 / s)
    out["hr"] = gather_patch(hr, vol, cout, (float(s), float(s), float(s)))
    return _split(out, temporal, b)


def dense_cell_index(lr: np.ndarray, density_threshold: float,
                     n_frames: int) -> tuple[np.ndarray, np.ndarray,
                                             tuple[int, int, int]]:
    """(dense, dense_t, pool): the (K, 4) rows (vol, zp, yp, xp) of pooled
    LR density cells at or above the threshold (every cell when none is),
    the same restricted to frames in [1, F−2] so that t±1 exist (all of
    ``dense`` when none is), and the pool per axis (2 where the axis
    allows it)."""
    d = lr[..., 0]
    pool = tuple(2 if d.shape[i + 1] >= 2 else 1 for i in range(3))
    nz, ny, nx = (d.shape[1] // pool[0]) * pool[0], \
        (d.shape[2] // pool[1]) * pool[1], (d.shape[3] // pool[2]) * pool[2]
    pooled = d[:, :nz, :ny, :nx].reshape(
        d.shape[0], nz // pool[0], pool[0], ny // pool[1], pool[1],
        nx // pool[2], pool[2]).mean(axis=(2, 4, 6))
    dense = np.argwhere(pooled >= density_threshold)
    if dense.shape[0] == 0:  # degenerate (all-empty data): allow anywhere
        dense = np.argwhere(np.ones_like(pooled, dtype=bool))
    frm = dense[:, 0] % n_frames
    dense_t = dense[(frm >= 1) & (frm <= n_frames - 2)]
    if dense_t.shape[0] == 0:
        dense_t = dense
    return dense.astype(np.int32), dense_t.astype(np.int32), pool


class TileCreator:
    """Holds device-resident volumes; samples augmented training batches."""

    def __init__(self, dataset: FluidDataset, tile_lr: int,
                 density_threshold: float = 0.002,
                 augment: bool = True, rot_mode: int = 2,
                 scale_min: float = 0.85, scale_max: float = 1.15,
                 device: str | torch.device | None = None):
        """``device``: where the volumes live and batches are assembled —
        CUDA unless the caller asks for the CPU."""
        self.device = resolve_device(device)
        self._host_lr = dataset.lr
        self._host_hr = dataset.hr
        self._dev: dict = {}
        n_frames = int(dataset.n_frames)
        dense, dense_t, pool = dense_cell_index(dataset.lr, density_threshold,
                                                n_frames)
        self.dense_idx = torch.from_numpy(dense).to(self.device, torch.int64)
        self.dense_idx_t = torch.from_numpy(dense_t).to(self.device,
                                                        torch.int64)
        self.st = TCStatic(
            tile_lr=int(tile_lr), up_res=int(dataset.up_res),
            n_vel=3 if dataset.use_velocities else 0,
            n_vort=3 if dataset.use_vorticities else 0,
            n_frames=n_frames, n_vols=int(dataset.lr.shape[0]),
            augment=bool(augment),
            rot_mode=int(rot_mode), scale_min=float(scale_min),
            scale_max=float(scale_max),
            dims_zyx=tuple(int(v) for v in dataset.lr.shape[1:4]),
            pool_zyx=pool,
        )

    @property
    def up_res(self) -> int:
        return self.st.up_res

    # lazy device tensors -------------------------------------------------

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @property
    def lr(self) -> torch.Tensor:
        if "lr" not in self._dev:
            self._dev["lr"] = self._put(self._host_lr)
        return self._dev["lr"]

    @property
    def hr(self) -> torch.Tensor:
        if "hr" not in self._dev:
            self._dev["hr"] = self._put(self._host_hr)
        return self._dev["hr"]

    @property
    def hrz(self) -> torch.Tensor:
        """HR downsampled along z only (the pass-1 target); for 2D data
        (Z == 1) this is HR itself. Built one volume at a time into its
        final tensor, so the device holds at most one HR volume besides."""
        if "hrz" not in self._dev:
            z_factor = self._host_hr.shape[1] // self._host_lr.shape[1]
            if z_factor <= 1:
                self._dev["hrz"] = self.hr
            else:
                n = self._host_hr.shape[0]
                acc = torch.empty(
                    (n, self._host_hr.shape[1] // z_factor,
                     *self._host_hr.shape[2:]),
                    dtype=torch.float32, device=self.device)
                for i in range(n):
                    acc[i] = downsample_axis(self._put(self._host_hr[i]),
                                             factor=z_factor, axis=0)
                self._dev["hrz"] = acc
        return self._dev["hrz"]

    def _idx(self, temporal: bool) -> torch.Tensor:
        return self.dense_idx_t if temporal else self.dense_idx

    def _check(self, generator: torch.Generator):
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, volumes on "
                             f"{self.device}")

    def sample_pass1(self, generator: torch.Generator, batch: int,
                     temporal: bool = False, plane: str = "xy") -> dict:
        """Pass-1 batch: {'lr' (B,t,t,C), 'hr' (B,ts,ts,1)} [+ prev/next]."""
        self._check(generator)
        didx = self._idx(temporal)
        return assemble_pass1(self.lr, self.hrz, didx,
                              draw(generator, batch, didx, self.st), plane,
                              temporal, self.st)

    def sample_pass2(self, generator: torch.Generator, batch: int,
                     temporal: bool = False, plane: str = "xz") -> dict:
        """Pass-2 batch: {'interm' (B,t,ts,1), 'lr_vel' (B,t,ts,3),
        'hr' (B,ts,ts,1)} [+ prev/next]. The input source is ``hrz``
        (training G2 on G1 outputs is not ported yet)."""
        self._check(generator)
        didx = self._idx(temporal)
        return assemble_pass2(self.lr, self.hrz, self.hr, didx,
                              draw(generator, batch, didx, self.st), plane,
                              temporal, self.st)
