"""Plain float32 reference of steps of pass-2 GAN training.

The second pass of the Multi-pass GAN (arXiv:1906.01689, §3): the slice
generator G2 refines the volume along z over xz slices. Its input is the
frozen first pass's intermediate volume (``interm``: the HR grid in y and
x, the LR grid in z) and the LR velocity, each gathered on an xz plane at
LR spacing along z (h) and HR spacing along x (w); its output and target
are HR along both. The step is the pass-1 recipe's (:mod:`train`): a
D-run updating the spatial discriminator Ds and the temporal discriminator
Dt (tempoGAN, arXiv:1801.09710; hinge loss, lazy R1), a G-run updating G2
(adversarial, L1, feature and temporal terms), each with Adam, then G2's
EMA; with pass 2's shapes:

- the velocity channels in the xz plane's order: (v_w, v_h, v_out) =
  (vx, vz, vy), the in-plane pair turned by the augmentation's inverse and
  v_out scaled by √|det A⁻¹|;
- the slice normal (y) on the HR lattice, the in-plane centre on the LR
  lattice's half-integers, as in pass 1;
- the velocity resized by (s_in, 1) to the output grid and put in output
  pixels: w by ``up_res`` (the input's w is already on the HR grid), h by
  s_in;
- Ds's input conditioned by G2's input resized by (s_in, 1).

The batch is drawn as :mod:`train` draws it (:func:`train.draw`), so that
the reference tiles are the program's. ``interm`` is data here, as a
user's frozen-G1 files are: the reference takes the volumes the program
trained on. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import nets
from port_bench.reference import train as ref_train
from port_bench.reference.train import (Adam, _grads, align, draw, r1,
                                        step_seed, trilinear)


def xz_coords(center, a, h, w, spacing_h, spacing_w):
    """(B, h, w, 3) LR-space (z, y, x) coordinates of an xz patch: h along
    z, w along x, ``spacing_*`` LR cells apart, rotated and scaled by
    ``a``, at y = the centre's."""
    dev = center.device
    off_h = (torch.arange(h, dtype=torch.float32, device=dev)
             - (h - 1) / 2.0) * spacing_h
    off_w = (torch.arange(w, dtype=torch.float32, device=dev)
             - (w - 1) / 2.0) * spacing_w
    dh, dw = off_h[:, None].expand(h, w), off_w[None, :].expand(h, w)
    rh = a[:, 0, 0, None, None] * dh + a[:, 0, 1, None, None] * dw
    rw = a[:, 1, 0, None, None] * dh + a[:, 1, 1, None, None] * dw
    cy = center[:, 1, None, None].expand(-1, h, w)
    return torch.stack([center[:, 0, None, None] + rh, cy,
                        center[:, 2, None, None] + rw], -1)


def to_index(coords, scale):
    """LR-space coordinates → index coordinates of a stack ``scale`` times
    finer per axis (z, y, x)."""
    s = torch.tensor(scale, dtype=torch.float32, device=coords.device)
    return (coords + 0.5) * s - 0.5


def centres(data: dict, gen: torch.Generator, rec: dict):
    """(volume, centre (z, y, x), A, A⁻¹) of a batch: the draws in the
    recipe's order, z and x clipped to the margin and snapped to the
    half-integer lattice, y on the nearest HR plane."""
    b, t, s = rec["batch"], rec["tile_lr"], rec["up_res"]
    cells, pool = data["cells"], data["pool"]
    pick, jitter, a, ainv = draw(gen, b, cells.shape[0], rec)
    m = (t - 1) / 2.0 * rec["scale_max"] * float(np.sqrt(2.0)) + 1.0
    half = (t - 1) / 2.0
    row = cells[pick]
    pool_t = torch.tensor(pool, dtype=torch.float32, device=row.device)
    raw = row[:, 1:4].float() * pool_t + jitter * pool_t
    dims = data["lr"].shape[1:4]

    def in_plane(c, size):
        return torch.floor(c.clamp(m, max(size - 1 - m, m)) - half) + half
    j = torch.round((raw[:, 1] + 0.5) * s - 0.5).clamp(0, dims[1] * s - 1)
    center = torch.stack([in_plane(raw[:, 0], dims[0]), (j + 0.5) / s - 0.5,
                          in_plane(raw[:, 2], dims[2])], -1)
    return row[:, 0], center, a, ainv


def sample(data: dict, gen: torch.Generator, rec: dict) -> dict:
    """A pass-2 temporal batch: ``interm`` (B, t, t·s, 1), ``lr_vel`` (B,
    t, t·s, 3) and ``hr`` (B, t·s, t·s, 1), each also ``_prev`` /
    ``_next`` (volumes v ∓ 1 at the same place)."""
    b, t, s = rec["batch"], rec["tile_lr"], rec["up_res"]
    v, center, a, ainv = centres(data, gen, rec)
    vol = torch.cat([v, v - 1, v + 1])
    center, a, ainv = center.repeat(3, 1), a.repeat(3, 1, 1), \
        ainv.repeat(3, 1, 1)
    cin = xz_coords(center, a, t, t * s, 1.0, 1.0 / s)
    interm = trilinear(data["interm"], vol, to_index(cin, (1.0, s, s)))
    lrp = trilinear(data["lr"], vol, to_index(cin, (1.0, 1.0, 1.0)))
    vw, vh, vout = lrp[..., 1], lrp[..., 3], lrp[..., 2]
    e = [ainv[:, i, j, None, None] for i in (0, 1) for j in (0, 1)]
    det = ainv[:, 0, 0] * ainv[:, 1, 1] - ainv[:, 0, 1] * ainv[:, 1, 0]
    lr_vel = torch.stack([e[2] * vh + e[3] * vw, e[0] * vh + e[1] * vw,
                          vout * det.abs().sqrt()[:, None, None]], -1)
    cout = xz_coords(center, a, t * s, t * s, 1.0 / s, 1.0 / s)
    hr = trilinear(data["hr"], vol, to_index(cout, (s, s, s)))
    out = {}
    for k, x in (("interm", interm), ("lr_vel", lr_vel), ("hr", hr)):
        out[k], out[f"{k}_prev"], out[f"{k}_next"] = x.split(b)
    return out


def g_input(bt: dict, which: str = "") -> torch.Tensor:
    """G2's input: the intermediate density and the velocity."""
    return torch.cat([bt[f"interm{which}"], bt[f"lr_vel{which}"]], -1)


def velocity(lr_vel: torch.Tensor, s_in: int, up_res: int) -> torch.Tensor:
    """The centre frame's (v_w, v_h) on the output grid, in output pixels:
    resized by (s_in, 1), w by ``up_res`` and h by ``s_in``."""
    v = nets.up(lr_vel[..., 0:2].permute(0, 3, 1, 2), s_in, 1)
    v = v.permute(0, 2, 3, 1)
    return torch.cat([v[..., 0:1] * up_res, v[..., 1:2] * s_in], -1)


def condition(x: torch.Tensor, hr: torch.Tensor, s_in: int) -> torch.Tensor:
    """Ds's input: G2's input resized by (s_in, 1), then the HR patch."""
    up = nets.up(x.permute(0, 3, 1, 2), s_in, 1).permute(0, 2, 3, 1)
    return torch.cat([up, hr], -1)


def pass2_data(lr: torch.Tensor, interm: torch.Tensor, hr: torch.Tensor,
               rec: dict) -> dict:
    """The resident set as the reference reads it: the LR stack, the
    intermediate and HR volumes, and the dense-cell index."""
    cells, pool = ref_train.dense_cells(lr[..., 0], rec["density_threshold"],
                                        rec["n_frames"])
    return {"lr": lr.float(), "interm": interm, "hr": hr, "cells": cells,
            "pool": pool}


def hinge_margins(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """The hinge loss's 2B margins, 1 − real and 1 + fake: the loss is the
    sum of the positive ones over B."""
    return torch.cat([1.0 - real, 1.0 + fake]).flatten()


def _term_grads(term: torch.Tensor, params: dict) -> dict:
    gs = torch.autograd.grad(term, list(params.values()), retain_graph=True,
                             allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), gs)}


def run(cfg: dict, params: dict, data: dict, seed: int, steps: int,
        quant=None, fault: str | None = None, start: dict | None = None,
        kink_delta: float | None = None) -> dict:
    """``steps`` pass-2 train steps from ``params`` ({"gen", "ds", "dt"} →
    flat dicts), as :func:`train.run` takes and returns them (the same
    ``start``, ``quant`` and ``fault`` ``"half_batch"``; ``fault``
    ``"no_r1"`` skips lazy R1 at its steps, ``"w_units"`` leaves the
    velocity's w in LR cells); also ``margins``, by net, the 2B hinge
    margins of the first step's D updates, and ``triplet``, the first
    step's aligned real triplet (its D-run's batch).

    The hinge loss has no derivative where a margin is 0, and a program in
    a lower precision may put a margin within its rounding of 0 on the
    other side, which moves the net's gradient by that term's whole
    gradient, and G's gradient in the same step by the discriminator's
    update. With ``kink_delta``, ``kinks`` gives by net each margin of
    the first step's D update under ``kink_delta`` in size, as (index,
    margin, the gradient of its term, the margin over B, by leaf);
    ``kinks_gen``, for each of them, how much G's first gradient moves by
    leaf when that term is counted the other way in its update."""
    rec, g_desc = cfg["recipe"], cfg["generator"]
    ds_desc, dt_desc = cfg["spatial_disc"], cfg["temporal_disc"]
    up_res = rec["up_res"]
    s_in = math.prod(f[0] for f in g_desc["factors"])
    unit_w = 1 if fault == "w_units" else up_res
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
    out = {"d_loss": [], "dt_loss": [], "g_loss": [], "grads0": {},
           "margins": {}, "kinks": {}, "kinks_gen": []}
    # the discriminators as they would be after the first step's update
    # with each kink term counted the other way: (net, params)
    turned = []
    keep = (lambda t: t[:t.shape[0] // 2]) if fault == "half_batch" \
        else (lambda t: t)

    def G(x, pp):
        return nets.generator(pp, g_desc, x, quant)

    def Ds(x, pp, feats=False):
        return nets.discriminator(pp, ds_desc, x, quant, feats)

    def Dt(x, pp):
        return nets.discriminator(pp, dt_desc, x, quant)

    def triplet(bt, pp):
        return G(torch.cat([g_input(bt, "_prev"), g_input(bt),
                            g_input(bt, "_next")]), pp).chunk(3)

    def d_update(name, disc, real, fake, r1_on, grads_out):
        pp = {k: v.requires_grad_(True) for k, v in p[name].items()}
        real, fake = keep(real), keep(fake)
        lr_, lf_ = disc(torch.cat([real, fake]), pp).chunk(2)
        b = lr_.shape[0]
        m = hinge_margins(lr_, lf_)
        loss = torch.relu(m).sum() / b
        if r1_on:
            loss = loss + gam * r1(lambda x: disc(x, pp), real)
        terms = []
        if grads_out is not None:
            md_ = m.detach()
            out["margins"][name] = md_
            if kink_delta is not None:
                near = (md_.abs() < kink_delta).nonzero().flatten()
                terms = [(i, float(md_[i]), _term_grads(m[i] / b, pp))
                         for i in near.tolist()]
                out["kinks"][name] = terms
        grads = _grads(loss, pp)
        if grads_out is not None:
            grads_out[name] = grads
        held = {k: v.detach() for k, v in pp.items()}
        for _, mi, t in terms:
            sign = -1.0 if mi > 0 else 1.0
            other = Adam(held, opt[name].lr, b1, b2, eps, opt[name].state())
            turned.append((name, other.step(held, {
                k: g + sign * t[k] for k, g in grads.items()})))
        p[name] = opt[name].step(held, grads)
        return loss.detach()

    def g_total(bt, pg, pds, pdt):
        """The G-run's loss on ``bt`` with G at ``pg``, Ds at ``pds`` and
        Dt at ``pdt``."""
        fp, fc, fn = triplet(bt, pg)
        x, hr = g_input(bt), bt["hr"]
        l1 = (fc - hr).abs().mean()
        logits, ff = Ds(condition(x, fc, s_in), pds, True)
        with torch.no_grad():
            _, fr = Ds(condition(x, hr, s_in), pds, True)
        feat = sum(((a - b) ** 2).mean() for a, b in zip(fr, ff))
        v = velocity(bt["lr_vel"], s_in, unit_w)
        l_t = -Dt(align(fp, fc, fn, v, md), pdt).mean()
        return (rec["lambda_adv"] * -logits.mean() + rec["lambda_l1"] * l1
                + rec["lambda_f"] * feat + rec["lambda_t"] * l_t)

    first = start["it"]
    for it in range(first, first + steps):
        gen.manual_seed(step_seed(seed, it))
        r1_on = it % max(rec["r1_interval"], 1) == 0 and fault != "no_r1"
        g0 = out["grads0"] if it == first else None
        # D-run
        bt = sample(data, gen, rec)
        x = g_input(bt)
        with torch.no_grad():
            fp, fc, fn = triplet(bt, p["gen"])
            v = velocity(bt["lr_vel"], s_in, unit_w)
            trip_fake = align(fp, fc, fn, v, md)
            trip_real = align(bt["hr_prev"], bt["hr"], bt["hr_next"], v, md)
            if it == first:
                out["triplet"] = trip_real
            real_in = condition(x, bt["hr"], s_in)
            fake_in = condition(x, fc, s_in)
        out["d_loss"].append(d_update("ds", Ds, real_in, fake_in, r1_on, g0))
        out["dt_loss"].append(d_update("dt", Dt, trip_real, trip_fake,
                                       r1_on, g0))
        # G-run
        bt = sample(data, gen, rec)
        bt = {k: keep(v) for k, v in bt.items()}
        pg = {k: v.requires_grad_(True) for k, v in p["gen"].items()}
        total = g_total(bt, pg, p["ds"], p["dt"])
        grads = _grads(total, pg)
        if g0 is not None:
            g0["gen"] = grads
            for name, other in turned:
                moved = _grads(g_total(bt, pg, *(
                    other if name == n else p[n] for n in ("ds", "dt"))), pg)
                out["kinks_gen"].append(
                    {k: moved[k] - g for k, g in grads.items()})
            turned.clear()
        p["gen"] = opt["gen"].step({k: v.detach() for k, v in pg.items()},
                                   grads)
        out["g_loss"].append(total.detach())
        d = rec["ema_decay"]
        ema = {k: ema[k] * d + p["gen"][k] * (1 - d) for k in ema}
    out.update(params=p, ema=ema,
               opt={name: o.state() for name, o in opt.items()})
    return out
