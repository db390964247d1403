"""Operations and bytes the benchmark's work needs, from shapes alone.

A convolution counts 2·k²·Cin·Cout operations per output pixel (a
multiply and an add per weight); the dense head of a discriminator
2·Cin·Cout per sample. Upsampling, activations, sums and copies are not
counted. In training a backward counts twice its forward. A warp launch
counts each byte it must read once and each byte it must write once.
Nothing here imports the program: the widths come from the configuration.
"""

from __future__ import annotations

import math
import os

# the published peaks of the card, read by the metric readers
PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def generator_flops(g: dict, h: int, w: int) -> int:
    """One slice of h×w input pixels through the generator ``g``."""
    base, out_c = g["base_filters"], g["out_channels"]
    total = 2 * 9 * g["in_channels"] * base * h * w
    width = base
    for k, (fh, fw) in enumerate(g["factors"]):
        h, w = h * fh, w * fw
        f = max(base // (2 ** (k + 1)), g["min_filters"])
        per_px = 0
        for _ in range(g["n_res_blocks"]):
            per_px += 2 * 9 * width * f + 2 * 9 * f * f
            if width != f:
                per_px += 2 * width * f
            width = f
        per_px += 2 * 9 * width * out_c
        total += per_px * h * w
    return total


def frame_flops(g1: dict, g2: dict, lr_shape: tuple[int, int, int],
                up_res: int) -> int:
    """A two-pass frame: G1 over the Z xy slices (Y×X), G2 over the Y·s
    xz slices (Z×X·s)."""
    z, y, x = lr_shape
    return (z * generator_flops(g1, y, x)
            + y * up_res * generator_flops(g2, z, x * up_res))


def discriminator_flops(d: dict) -> int:
    """One sample through the discriminator ``d`` at its last stage."""
    stage = len(d["factors"])
    h, w = d["in_hw"]

    def width(k):
        return min(max(d["base_filters"] // (2 ** k), d["min_filters"]),
                   d["max_filters"])
    total = 2 * 9 * d["in_channels"] * width(stage) * h * w
    for k in range(stage - 1, -1, -1):
        fh, fw = d["factors"][k]
        h, w = math.ceil(h / fh), math.ceil(w / fw)
        total += 2 * 9 * width(k + 1) * width(k) * h * w
        total += 2 * 9 * width(k) * width(k) * h * w
    return total + 2 * h * w * width(0)


def train_step_flops(cfg: dict) -> float:
    """One pass-1 temporal GAN step of the recipe: a D-run (G forward on the
    3B triplet frames; Ds and Dt forward and backward on B real + B fake),
    a G-run (G forward and backward on 3B frames; Ds forward and backward
    on B fakes and forward on B reals; Dt forward and backward on B
    triplets), and lazy R1 at its rate: per R1 step, a forward of Ds and of
    Dt on the B reals with the backward to their input (3 forwards), whose
    own backward to the parameters counts twice that (9 forwards in all)."""
    rec = cfg["recipe"]
    b, t = rec["batch"], rec["tile_lr"]
    gf = generator_flops(cfg["generator"], t, t)
    dsf = discriminator_flops(cfg["spatial_disc"])
    dtf = discriminator_flops(cfg["temporal_disc"])
    d_run = 3 * b * gf + 3 * (2 * b) * dsf + 3 * (2 * b) * dtf
    g_run = 3 * (3 * b) * gf + 3 * b * dsf + b * dsf + 3 * b * dtf
    r1 = 9 * b * (dsf + dtf) / max(rec["r1_interval"], 1)
    return d_run + g_run + r1


def warp_bytes(b: int, h: int, w: int, backward: bool,
               vel_grad: bool = False) -> int:
    """Bytes a triplet warp launch must move, float32 fields of b×h×w.
    Forward: prev, cur, next and the 2-channel velocity in, 3 channels
    out. Backward: the prev and next channels of the incoming gradient and
    the velocity in, the gradients of prev and next out; with
    ``vel_grad`` also prev and next in and the velocity's gradient out."""
    px = b * h * w * 4
    if not backward:
        return px * (3 + 2 + 3)
    n = px * (2 + 2 + 2)
    if vel_grad:
        n += px * (2 + 2)
    return n


def train_warp_bytes(cfg: dict) -> int:
    """A step's warp launches: the fake and real triplets of the D-run and
    the fake triplet of the G-run forward, the G-run's backward (no
    velocity gradient: the velocity is data)."""
    rec = cfg["recipe"]
    b, hw = rec["batch"], rec["tile_lr"] * rec["up_res"]
    return 3 * warp_bytes(b, hw, hw, False) + warp_bytes(b, hw, hw, True)
