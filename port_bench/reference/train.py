"""Plain float32 reference of steps of pass-1 GAN training.

The flagship recipe's step, written again from its equations: a batch of
augmented tiles gathered from the resident volumes, then one update of the
spatial discriminator Ds and one of the temporal discriminator Dt (hinge
loss, lazy R1), then one update of the generator G (adversarial, L1,
feature and temporal terms), each with Adam, then the generator's EMA.

The batch is drawn from a ``torch.Generator`` of the card seeded per
iteration, with the same calls in the same order as the recipe states
(rows of the dense-cell index, their jitter, then the augmentation's angle,
flips and scale), so that the reference tiles are the program's tiles. The
HR target of pass 1 (the HR density blurred and box-averaged along z) and
the dense-cell index are worked out here again from the raw volumes.
Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference import nets


def step_seed(seed: int, it: int) -> int:
    """The seed of iteration ``it``'s sampling stream."""
    return int(np.random.SeedSequence([seed, it]).generate_state(
        1, np.uint64)[0])


# ------------------------------------------------------------------- data

def dense_cells(lr_density: torch.Tensor, threshold: float, n_frames: int
                ) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """(K, 4) int64 rows (volume, zp, yp, xp) of the 2×2×2-pooled LR
    density cells at or above ``threshold`` (every cell when none is),
    restricted to frames 1 … F−2 (so that both neighbours exist), row-major;
    and the pool per axis."""
    n, z, y, x = lr_density.shape
    pool = tuple(2 if s >= 2 else 1 for s in (z, y, x))
    d = lr_density[:, :z // pool[0] * pool[0], :y // pool[1] * pool[1],
                   :x // pool[2] * pool[2]]
    pooled = d.reshape(n, z // pool[0], pool[0], y // pool[1], pool[1],
                       x // pool[2], pool[2]).mean(dim=(2, 4, 6))
    cells = torch.nonzero(pooled >= threshold)
    if cells.shape[0] == 0:
        cells = torch.nonzero(torch.ones_like(pooled, dtype=torch.bool))
    frame = cells[:, 0] % n_frames
    inner = cells[(frame >= 1) & (frame <= n_frames - 2)]
    return (inner if inner.shape[0] else cells), pool


def blur_down_z(hr: torch.Tensor, factor: int) -> torch.Tensor:
    """(n, Zs, Ys, Xs, 1) → (n, Zs/f, Ys, Xs, 1): a Gaussian blur along z
    (σ = f/2, radius ⌈3σ⌉, edges replicated), then the mean of each f
    planes."""
    sigma = factor / 2.0
    radius = max(1, int(math.ceil(3.0 * sigma)))
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = torch.tensor(k / k.sum(), dtype=torch.float32, device=hr.device)
    zs = hr.shape[1]
    idx = torch.arange(-radius, zs + radius, device=hr.device).clamp(0, zs - 1)
    padded = hr.index_select(1, idx)
    out = sum(padded[:, i:i + zs] * k[i] for i in range(2 * radius + 1))
    return out.reshape(hr.shape[0], zs // factor, factor,
                       *hr.shape[2:]).mean(dim=2)


def trilinear(vols: torch.Tensor, vol: torch.Tensor,
              coords: torch.Tensor) -> torch.Tensor:
    """``vols`` (N, Z, Y, X, C) sampled at index coords (B, h, w, 3) as
    (z, y, x), sample b from volume ``vol[b]``, border-clamped."""
    _, d, h, w, _ = vols.shape
    sizes = (d, h, w)
    lo, hi, fr = [], [], []
    for a in range(3):
        c = coords[..., a].clamp(0.0, sizes[a] - 1.0)
        f = torch.floor(c)
        lo.append(f.long())
        hi.append((f.long() + 1).clamp(max=sizes[a] - 1))
        fr.append((c - f)[..., None])
    v = vol.view(-1, 1, 1)

    def at(iz, iy, ix):
        return vols[v, iz, iy, ix]

    out = 0.0
    for cz, wz in ((lo[0], 1 - fr[0]), (hi[0], fr[0])):
        for cy, wy in ((lo[1], 1 - fr[1]), (hi[1], fr[1])):
            for cx, wx in ((lo[2], 1 - fr[2]), (hi[2], fr[2])):
                out = out + at(cz, cy, cx) * (wz * wy * wx)
    return out


def draw(gen: torch.Generator, batch: int, n_cells: int, aug: dict):
    """(pick, jitter, A, A⁻¹): the random part of a batch, in the recipe's
    order of draws."""
    dev = gen.device
    pick = torch.randint(0, n_cells, (batch,), generator=gen, device=dev)
    jitter = torch.rand((batch, 3), generator=gen, device=dev)
    theta = torch.rand(batch, generator=gen, device=dev) * (2.0 * math.pi)
    flips = torch.rand((batch, 2), generator=gen, device=dev) < 0.5
    sigma = aug["scale_min"] + torch.rand(batch, generator=gen, device=dev) \
        * (aug["scale_max"] - aug["scale_min"])
    fy = 1.0 - 2.0 * flips[:, 0].float()
    fx = 1.0 - 2.0 * flips[:, 1].float()
    c, s = torch.cos(theta), torch.sin(theta)
    a = sigma[:, None, None] * torch.stack(
        [torch.stack([c * fy, -s * fx], -1),
         torch.stack([s * fy, c * fx], -1)], -2)
    ainv = torch.stack([torch.stack([c * fy, s * fy], -1),
                        torch.stack([-s * fx, c * fx], -1)], -2) \
        / sigma[:, None, None]
    return pick, jitter, a, ainv


def patch_coords(center, a, n, spacing):
    """(B, n, n, 3) LR-space (z, y, x) coordinates of an xy patch of n×n
    pixels ``spacing`` LR cells apart, rotated and scaled by ``a``."""
    off = (torch.arange(n, dtype=torch.float32, device=center.device)
           - (n - 1) / 2.0) * spacing
    dh, dw = off[:, None].expand(n, n), off[None, :].expand(n, n)
    ry = a[:, 0, 0, None, None] * dh + a[:, 0, 1, None, None] * dw
    rx = a[:, 1, 0, None, None] * dh + a[:, 1, 1, None, None] * dw
    cz = center[:, 0, None, None].expand(-1, n, n)
    return torch.stack([cz, center[:, 1, None, None] + ry,
                        center[:, 2, None, None] + rx], -1)


def sample(data: dict, gen: torch.Generator, rec: dict) -> dict:
    """A pass-1 temporal batch: ``lr`` (B, t, t, 4) and ``hr`` (B, t·s,
    t·s, 1), each also ``_prev`` / ``_next`` (volumes v ∓ 1 at the same
    place)."""
    b, t, s = rec["batch"], rec["tile_lr"], rec["up_res"]
    cells, pool = data["cells"], data["pool"]
    pick, jitter, a, ainv = draw(gen, b, cells.shape[0], rec)
    m = (t - 1) / 2.0 * rec["scale_max"] * float(np.sqrt(2.0)) + 1.0
    half = (t - 1) / 2.0
    row = cells[pick]
    pool_t = torch.tensor(pool, dtype=torch.float32, device=row.device)
    raw = row[:, 1:4].float() * pool_t + jitter * pool_t
    dims = data["lr"].shape[1:4]
    cz = torch.round(raw[:, 0]).clamp(0, dims[0] - 1)
    cy = torch.floor(raw[:, 1].clamp(m, max(dims[1] - 1 - m, m)) - half) + half
    cx = torch.floor(raw[:, 2].clamp(m, max(dims[2] - 1 - m, m)) - half) + half
    center = torch.stack([cz, cy, cx], -1).repeat(3, 1)
    vol = torch.cat([row[:, 0], row[:, 0] - 1, row[:, 0] + 1])
    a3, ainv3 = a.repeat(3, 1, 1), ainv.repeat(3, 1, 1)
    lc = (patch_coords(center, a3, t, 1.0) + 0.5) * torch.ones(
        3, device=center.device) - 0.5
    lrp = trilinear(data["lr"], vol, lc)
    e = [ainv3[:, i, j, None, None] for i in (0, 1) for j in (0, 1)]
    vx, vy = lrp[..., 1], lrp[..., 2]
    det = ainv3[:, 0, 0] * ainv3[:, 1, 1] - ainv3[:, 0, 1] * ainv3[:, 1, 0]
    lrp = torch.stack([lrp[..., 0], e[2] * vy + e[3] * vx,
                       e[0] * vy + e[1] * vx,
                       lrp[..., 3] * det.abs().sqrt()[:, None, None]], -1)
    hc = patch_coords(center, a3, t * s, 1.0 / s)
    hc = (hc + 0.5) * torch.tensor([1.0, s, s], device=hc.device) - 0.5
    hrp = trilinear(data["hrz"], vol, hc)
    out = {}
    for k, v in (("lr", lrp), ("hr", hrp)):
        out[k], out[f"{k}_prev"], out[f"{k}_next"] = v.split(b)
    return out


def pass1_data(lr: torch.Tensor, hr: torch.Tensor, rec: dict,
               volumes: torch.Tensor | None = None) -> dict:
    """The resident set as the reference reads it: the LR stack, the
    dense-cell index, and the pass-1 target of the volumes in
    ``volumes`` (all when None; the others are left zero)."""
    cells, pool = dense_cells(lr[..., 0], rec["density_threshold"],
                              rec["n_frames"])
    z = lr.shape[1]
    f = hr.shape[1] // z
    hrz = torch.zeros((hr.shape[0], z, *hr.shape[2:]), dtype=torch.float32,
                      device=hr.device)
    ids = (torch.arange(hr.shape[0], device=hr.device) if volumes is None
           else volumes.unique())
    for blk in ids.split(32):
        hrz[blk] = blur_down_z(hr[blk].float(), f)
    return {"lr": lr.float(), "hrz": hrz, "cells": cells, "pool": pool}


def drawn_volumes(lr: torch.Tensor, rec: dict, seed: int, iters
                  ) -> torch.Tensor:
    """The volumes the batches of the iterations ``iters`` read."""
    cells, _ = dense_cells(lr[..., 0], rec["density_threshold"],
                           rec["n_frames"])
    gen = torch.Generator(device=lr.device)
    out = []
    for it in iters:
        gen.manual_seed(step_seed(seed, it))
        for _ in range(2):           # the D-run's batch, then the G-run's
            pick = draw(gen, rec["batch"], cells.shape[0], rec)[0]
            v = cells[pick, 0]
            out += [v, v - 1, v + 1]
    return torch.cat(out)


# ----------------------------------------------------------------- pieces

def warp(field: torch.Tensor, vel: torch.Tensor, dt: float,
         max_disp: float) -> torch.Tensor:
    """Semi-Lagrangian warp of (B, H, W, 1) by (B, H, W, 2) (v_w, v_h):
    each cell reads the field bilinearly, border-clamped, at x − dt·v, the
    velocity first clipped to ±max_disp/|dt|."""
    b, h, w, _ = field.shape
    lim = max_disp / abs(dt)
    v = vel.clamp(-lim, lim)
    yy = torch.arange(h, dtype=torch.float32, device=field.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=field.device)[None, :]
    y = (yy - dt * v[..., 1]).clamp(0.0, h - 1.0)
    x = (xx - dt * v[..., 0]).clamp(0.0, w - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    y0, x0 = y0.long(), x0.long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    f = field[..., 0]
    bi = torch.arange(b, device=field.device)[:, None, None]
    top = f[bi, y0, x0] * (1 - fx) + f[bi, y0, x1] * fx
    bot = f[bi, y1, x0] * (1 - fx) + f[bi, y1, x1] * fx
    return (top * (1 - fy) + bot * fy)[..., None]


def align(prev, cur, nxt, vel, max_disp):
    return torch.cat([warp(prev, vel, 1.0, max_disp), cur,
                      warp(nxt, vel, -1.0, max_disp)], -1)


def upsample_nhwc(x, f):
    return nets.up(x.permute(0, 3, 1, 2), f, f).permute(0, 2, 3, 1)


def vel_hr(lr: torch.Tensor, f: int) -> torch.Tensor:
    """The centre frame's (v_w, v_h) on the HR tile's grid, in HR pixels."""
    return upsample_nhwc(lr[..., 1:3], f) * f


def hinge_d(real, fake):
    return F.relu(1.0 - real).mean() + F.relu(1.0 + fake).mean()


def r1(disc, x):
    x = x.detach().requires_grad_(True)
    g, = torch.autograd.grad(disc(x).sum(), x, create_graph=True)
    return (g ** 2).sum(dim=(1, 2, 3)).mean()


class Adam:
    """Adam with ε outside the square root, bias-corrected."""

    def __init__(self, params: dict, lr: float, b1: float, b2: float,
                 eps: float, state: dict | None = None):
        """``state``: the moments ``m``, ``v`` and the step count ``t`` to
        start from (zero when None)."""
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        if state is None:
            state = {"m": {k: torch.zeros_like(v) for k, v in params.items()},
                     "v": {k: torch.zeros_like(v) for k, v in params.items()},
                     "t": 0}
        self.m = {k: v.detach().clone().float()
                  for k, v in state["m"].items()}
        self.v = {k: v.detach().clone().float()
                  for k, v in state["v"].items()}
        self.t = int(state["t"])

    def state(self) -> dict:
        return {"m": self.m, "v": self.v, "t": self.t}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            out[k] = p - self.lr * (self.m[k] / c1) / (
                (self.v[k] / c2).sqrt() + self.eps)
        return out


# ------------------------------------------------------------------- step

def _grads(loss: torch.Tensor, params: dict) -> dict:
    """The gradient of every parameter, zero where the loss does not reach
    it (an input head that only a fade uses): Adam then leaves it be."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), gs)}


def run(cfg: dict, params: dict, data: dict, seed: int, steps: int,
        quant=None, fault: str | None = None, start: dict | None = None
        ) -> dict:
    """``steps`` train steps from ``params`` ({"gen", "ds", "dt"} → flat
    dicts) → per-step losses ``d_loss``, ``dt_loss``, ``g_loss``; the first
    step's gradients per net (``grads0``); the parameters after the last
    step (with ``ema``) and the optimizers' state (``opt``). ``start``
    continues a run: the iteration ``it`` of the first step, the
    optimizers' state per net (``opt``, as returned) and the ``ema``
    (from iteration 0, fresh optimizers and the EMA at ``params`` when
    None). ``fault``: ``"half_batch"`` takes every loss over the first half
    of the rows only."""
    rec, g_desc = cfg["recipe"], cfg["generator"]
    ds_desc, dt_desc = cfg["spatial_disc"], cfg["temporal_disc"]
    f = rec["up_res"]
    md = rec["warp_max_disp"]
    gam = 0.5 * rec["r1_gamma"] * rec["r1_interval"]
    b1, b2, eps = rec["beta1"], rec["beta2"], rec["adam_eps"]
    p = {k: {n: t.detach().clone().float() for n, t in v.items()}
         for k, v in params.items()}
    start = start or {"it": 0, "opt": {}, "ema": p["gen"]}
    ema = {n: t.detach().clone().float() for n, t in start["ema"].items()}
    opt = {name: Adam(p[name], rec[lr], b1, b2, eps, start["opt"].get(name))
           for name, lr in (("gen", "lr_gen"), ("ds", "lr_disc"),
                            ("dt", "lr_disc"))}
    gen = torch.Generator(device=data["lr"].device)
    out = {"d_loss": [], "dt_loss": [], "g_loss": [], "grads0": {}}
    keep = (lambda t: t[:t.shape[0] // 2]) if fault == "half_batch" \
        else (lambda t: t)

    def G(x, pp):
        return nets.generator(pp, g_desc, x, quant)

    def Ds(x, pp, feats=False):
        return nets.discriminator(pp, ds_desc, x, quant, feats)

    def Dt(x, pp):
        return nets.discriminator(pp, dt_desc, x, quant)

    def cond(lr, hr):
        return torch.cat([upsample_nhwc(lr, f), hr], -1)

    def d_update(name, disc, real, fake, r1_on, grads_out):
        pp = {k: v.requires_grad_(True) for k, v in p[name].items()}
        real, fake = keep(real), keep(fake)
        logits = disc(torch.cat([real, fake]), pp)
        lr_, lf_ = logits.chunk(2)
        loss = hinge_d(lr_, lf_)
        if r1_on:
            loss = loss + gam * r1(lambda x: disc(x, pp), real)
        grads = _grads(loss, pp)
        if grads_out is not None:
            grads_out[name] = grads
        p[name] = opt[name].step({k: v.detach() for k, v in pp.items()},
                                 grads)
        return loss.detach()

    first = start["it"]
    for it in range(first, first + steps):
        gen.manual_seed(step_seed(seed, it))
        r1_on = it % max(rec["r1_interval"], 1) == 0
        g0 = out["grads0"] if it == first else None
        # D-run
        bt = sample(data, gen, rec)
        with torch.no_grad():
            fp, fc, fn = G(torch.cat([bt["lr_prev"], bt["lr"],
                                      bt["lr_next"]]), p["gen"]).chunk(3)
            v = vel_hr(bt["lr"], f)
            trip_fake = align(fp, fc, fn, v, md)
            trip_real = align(bt["hr_prev"], bt["hr"], bt["hr_next"], v, md)
            real_in, fake_in = cond(bt["lr"], bt["hr"]), cond(bt["lr"], fc)
        out["d_loss"].append(d_update(
            "ds", lambda x, pp: Ds(x, pp), real_in, fake_in, r1_on, g0))
        out["dt_loss"].append(d_update(
            "dt", lambda x, pp: Dt(x, pp), trip_real, trip_fake, r1_on, g0))
        # G-run
        bt = sample(data, gen, rec)
        pg = {k: v.requires_grad_(True) for k, v in p["gen"].items()}
        xs = torch.cat([keep(bt["lr_prev"]), keep(bt["lr"]),
                        keep(bt["lr_next"])])
        fp, fc, fn = G(xs, pg).chunk(3)
        lr_c, hr_c = keep(bt["lr"]), keep(bt["hr"])
        l1 = (fc - hr_c).abs().mean()
        logits, ff = Ds(cond(lr_c, fc), p["ds"], True)
        with torch.no_grad():
            _, fr = Ds(cond(lr_c, hr_c), p["ds"], True)
        feat = sum(((a - b) ** 2).mean() for a, b in zip(fr, ff))
        v = vel_hr(lr_c, f)
        l_t = -Dt(align(fp, fc, fn, v, md), p["dt"]).mean()
        total = (rec["lambda_adv"] * -logits.mean() + rec["lambda_l1"] * l1
                 + rec["lambda_f"] * feat + rec["lambda_t"] * l_t)
        grads = _grads(total, pg)
        if g0 is not None:
            g0["gen"] = grads
        p["gen"] = opt["gen"].step({k: v.detach() for k, v in pg.items()},
                                   grads)
        out["g_loss"].append(total.detach())
        d = rec["ema_decay"]
        ema = {k: ema[k] * d + p["gen"][k] * (1 - d) for k in ema}
    out.update(params=p, ema=ema,
               opt={name: o.state() for name, o in opt.items()})
    return out
