"""Device-side tile creator — counterpart of ``mpgan_tpu/data/pipeline.py``.

A training batch is a set of coordinate grids in LR physical space,
rotated / flipped / scaled by the augmentation transform and gathered from
the resident volumes by trilinear interpolation (one resampling step),
with velocity channels multiplied by the inverse Jacobian. Everything per
batch runs on the tile creator's device.

Each sampler is split in two:
- *draw* (:func:`draw`): an explicit ``torch.Generator`` yields the dense
  cells picked, their jitter and the transforms (:class:`Draws`);
- *assemble* (:func:`assemble_pass1`, :func:`assemble_pass2`,
  :func:`assemble_pass3`): a pure function of the volumes and the draws.
Tests inject draws into the second half; the JAX package's random bits
cannot be reproduced here.

Plane conventions (multi-pass slicing): 'xy' (pass 1): h = y, w = x, slice
normal z; 'xz' (pass 2): h = z, w = x, normal y; 'yz': h = y, w = z,
normal x. Gathered velocity channels are permuted to the per-plane layout
``[density, v_w, v_h, v_out]``.

Sources: ``lr`` (N, Z, Y, X, C) LR volumes; ``hrz`` (N, Z, Y·s, X·s, 1) HR
density downsampled along z only (the pass-1 target); ``interm`` (the
pass-2 input: frozen-G1 outputs, else ``hrz``); ``final`` (N, Z·s, Y·s,
X·s, 1) (the pass-3 input: two-pass outputs, else ``hr``); ``hr`` the full
HR density (the pass-2 and pass-3 target). Residency is lazy and per pass:
pass 1 puts only ``lr`` and ``hrz`` on the device, and ``hrz`` is built one
HR volume at a time.

Sharded residency (:meth:`TileCreator.shard_over`, JAX ``:415-456``): in a
data-parallel run each rank keeps only its block of whole sims on its card
and a shard-local dense-cell index (:func:`_shard_dense`), and draws its
share of the batch from them with its own generator.
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


def assemble_pass3(lr: torch.Tensor, final_src: torch.Tensor,
                   hr: torch.Tensor, dense_idx: torch.Tensor, draws: Draws,
                   plane: str, temporal: bool, st: TCStatic) -> dict:
    """Pass-3 batch from drawn values (JAX ``_sample_pass3``): {'final'
    (B,ts,ts,1), 'lr_vel' (B,ts,ts,3), 'hr' (B,ts,ts,1)} [+ '_prev' /
    '_next'], all at full-HR spacing and the same coordinates: a
    constant-resolution refinement patch."""
    vol, centers = _candidates(draws.pick, draws.jitter, plane, dense_idx, st,
                               normal_hr=True)
    b = vol.shape[0]
    vol, centers, a, ainv = _with_neighbours(vol, centers, draws.a,
                                             draws.ainv, temporal)
    t, s = st.tile_lr, st.up_res
    cin = plane_patch_coords(plane, centers, a, t * s, t * s, 1.0 / s,
                             1.0 / s)
    hr_scale = (float(s), float(s), float(s))
    out = {"final": gather_patch(final_src, vol, cin, hr_scale)}
    if st.n_vel:
        lrp = gather_patch(lr, vol, cin, (1.0, 1.0, 1.0))
        lrp = transform_vectors(_permute_channels(lrp, plane, st.n_vel),
                                ainv, st.n_vel)
        out["lr_vel"] = lrp[..., 1:4]
    out["hr"] = gather_patch(hr, vol, cin, hr_scale)
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


def _shard_dense(dense: np.ndarray, n_shards: int, vols_per_shard: int,
                 grid_shape: tuple[int, int, int],
                 temporal_frames: int | None = None) -> np.ndarray:
    """Partition a global (K, 4) dense-cell index by volume shard (JAX
    ``mpgan_tpu/data/pipeline.py:281-320``).

    Returns (n_shards·M, 4) with *shard-local* volume indices; each shard's
    block is cyclically tiled to the common length M = max per-shard count
    (rows stay intact: ``np.resize`` tiles the flat buffer and the row
    length divides it), so a uniform draw from a block keeps the
    within-shard distribution about uniform. A shard whose volumes hold no
    above-threshold cell takes a uniform lattice over all its pooled cells
    (subsampled to the others' size); with ``temporal_frames`` that lattice
    keeps to frames in [1, n_frames − 2], as the global temporal index
    does.
    """
    blocks = []
    for s in range(n_shards):
        lo = s * vols_per_shard
        blk = dense[(dense[:, 0] >= lo) &
                    (dense[:, 0] < lo + vols_per_shard)].copy()
        blk[:, 0] -= lo
        blocks.append(blk)
    cap = max([b.shape[0] for b in blocks if b.shape[0]] or [1024])
    for s, blk in enumerate(blocks):
        if blk.shape[0] == 0:  # an empty shard: anywhere local, uniform
            gz, gy, gx = grid_shape
            vols = np.arange(vols_per_shard)
            if temporal_frames is not None:
                # shards hold whole sims, so a local volume's frame is v % F
                frm = vols % temporal_frames
                ok = (frm >= 1) & (frm <= temporal_frames - 2)
                if ok.any():
                    vols = vols[ok]
            full = np.stack(np.meshgrid(
                vols, np.arange(gz), np.arange(gy),
                np.arange(gx), indexing="ij"), -1).reshape(-1, 4)
            if full.shape[0] > cap:
                sel = np.random.default_rng(s).choice(
                    full.shape[0], size=cap, replace=False)
                full = full[np.sort(sel)]
            blocks[s] = full.astype(dense.dtype)
    m = max(b.shape[0] for b in blocks)
    return np.concatenate([np.resize(b, (m, 4)) for b in blocks])


class TileCreator:
    """Holds device-resident volumes; samples augmented training batches."""

    def __init__(self, dataset: FluidDataset, tile_lr: int,
                 density_threshold: float = 0.002,
                 augment: bool = True, rot_mode: int = 2,
                 scale_min: float = 0.85, scale_max: float = 1.15,
                 device: str | torch.device | None = None,
                 interm: np.ndarray | torch.Tensor | None = None,
                 final: np.ndarray | torch.Tensor | None = None):
        """``device``: where the volumes live and batches are assembled —
        CUDA unless the caller asks for the CPU. ``interm``: optional
        (N, Z, Y·s, X·s, 1) pass-2 input volumes in place of ``hrz`` (the
        frozen G1's outputs, :func:`mpgan_torch.infer.assemble.
        precompute_intermediates`); ``final``: optional (N, Z·s, Y·s, X·s,
        1) pass-3 input volumes in place of ``hr`` (two-pass outputs,
        ``precompute_finals``). Both are placed on the device at first
        use."""
        self.device = resolve_device(device)
        self._host_lr = dataset.lr
        self._host_hr = dataset.hr
        self._dev: dict = {}
        self._src: dict = {}
        if interm is not None:
            hrz_shape = (dataset.hr.shape[0], dataset.lr.shape[1],
                         *dataset.hr.shape[2:])
            if tuple(interm.shape) != hrz_shape:
                raise ValueError(f"interm shape {tuple(interm.shape)} != "
                                 f"expected {hrz_shape}")
            self._src["interm"] = interm
        if final is not None:
            if tuple(final.shape) != tuple(dataset.hr.shape):
                raise ValueError(f"final shape {tuple(final.shape)} != "
                                 f"expected {tuple(dataset.hr.shape)}")
            self._src["final"] = final
        n_frames = int(dataset.n_frames)
        dense, dense_t, pool = dense_cell_index(dataset.lr, density_threshold,
                                                n_frames)
        self._host_dense, self._host_dense_t = dense, dense_t
        self._pooled_shape = tuple(int(d) // p for d, p in
                                   zip(dataset.lr.shape[1:4], pool))
        self.dense_idx = torch.from_numpy(dense).to(self.device, torch.int64)
        self.dense_idx_t = torch.from_numpy(dense_t).to(self.device,
                                                        torch.int64)
        self.n_shards, self.shard = 1, 0
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
        self.st_local = self.st

    @property
    def up_res(self) -> int:
        return self.st.up_res

    def shard_over(self, n_shards: int, shard: int) -> bool:
        """Keep only shard ``shard`` of ``n_shards`` on the device: a
        contiguous block of *whole sims* (so that t±1 neighbours stay in
        the block) and that block's rows of the dense-cell index, with
        shard-local volume numbers. The card then holds dataset/n_shards,
        and a draw samples the local block (JAX ``:415-456``).

        Applies only when the sim count divides over the shards; otherwise
        residency stays whole and this returns False. Idempotent for the
        same split; call it before the first batch (volumes already on the
        device are cut to the block)."""
        if self.n_shards > 1:
            if (self.n_shards, self.shard) == (n_shards, shard):
                return True
            raise RuntimeError("TileCreator already sharded another way")
        n_sims = self.st.n_vols // self.st.n_frames
        if n_shards <= 1 or n_sims % n_shards:
            return False
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} is not in [0, {n_shards})")
        vols = self.st.n_vols // n_shards
        lo, hi = shard * vols, (shard + 1) * vols
        self.n_shards, self.shard = n_shards, shard
        self.st_local = self.st._replace(n_vols=vols)
        self._host_lr = self._host_lr[lo:hi]
        self._host_hr = self._host_hr[lo:hi]
        self._src = {k: v[lo:hi] for k, v in self._src.items()}
        self._dev = {k: v[lo:hi].clone() for k, v in self._dev.items()}
        for name, host, tf in (("dense_idx", self._host_dense, None),
                               ("dense_idx_t", self._host_dense_t,
                                self.st.n_frames)):
            blocks = _shard_dense(host, n_shards, vols, self._pooled_shape,
                                  temporal_frames=tf)
            m = blocks.shape[0] // n_shards
            setattr(self, name, torch.from_numpy(
                blocks[shard * m:(shard + 1) * m]).to(self.device,
                                                      torch.int64))
        return True

    # lazy device tensors -------------------------------------------------

    def _put(self, x: np.ndarray | torch.Tensor) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
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

    @property
    def interm(self) -> torch.Tensor:
        """The pass-2 input source: the given ``interm``, else ``hrz``."""
        if "interm" not in self._dev:
            if "interm" not in self._src:
                return self.hrz
            self._dev["interm"] = self._put(self._src.pop("interm"))
        return self._dev["interm"]

    @property
    def final(self) -> torch.Tensor:
        """The pass-3 input source: the given ``final``, else ``hr``."""
        if "final" not in self._dev:
            if "final" not in self._src:
                return self.hr
            self._dev["final"] = self._put(self._src.pop("final"))
        return self._dev["final"]

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
                              draw(generator, batch, didx, self.st_local),
                              plane, temporal, self.st_local)

    def sample_pass2(self, generator: torch.Generator, batch: int,
                     temporal: bool = False, plane: str = "xz") -> dict:
        """Pass-2 batch: {'interm' (B,t,ts,1), 'lr_vel' (B,t,ts,3),
        'hr' (B,ts,ts,1)} [+ prev/next], the input from ``interm``."""
        self._check(generator)
        didx = self._idx(temporal)
        return assemble_pass2(self.lr, self.interm, self.hr, didx,
                              draw(generator, batch, didx, self.st_local),
                              plane, temporal, self.st_local)

    def sample_pass3(self, generator: torch.Generator, batch: int,
                     temporal: bool = False, plane: str = "yz") -> dict:
        """Pass-3 batch: {'final' (B,ts,ts,1), 'lr_vel' (B,ts,ts,3),
        'hr' (B,ts,ts,1)} [+ prev/next], the input from ``final``."""
        self._check(generator)
        didx = self._idx(temporal)
        return assemble_pass3(self.lr, self.final, self.hr, didx,
                              draw(generator, batch, didx, self.st_local),
                              plane, temporal, self.st_local)
