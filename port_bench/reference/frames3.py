"""Plain float32 reference of a three-pass super-resolved frame.

Passes 1 and 2 are :func:`port_bench.reference.frames.upscale`'s. Pass 3
runs G3 at constant resolution over the x-slices (yz planes) of the
(Zs, Ys, Xs, 1) volume: each slice is (Ys, Zs) with channels [d, vz, vy,
vx], the LR velocity resized trilinearly (half-pixel, edge-clamped) to the
full (Zs, Ys, Xs) grid, its values kept in LR cells per frame. The refined
slices are transposed back into (Zs, Ys, Xs, 1). Slices go through G3 in
blocks, so that a full-size frame fits beside the program's state.

Departures from the program: none in the arithmetic. The program resizes
the velocity in the configuration's dtype (bfloat16) and this reference in
float32; that rounding is part of the error the comparison reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference import frames, nets


def upscale(p1: dict, g1: dict, p2: dict, g2: dict, p3: dict, g3: dict,
            lr: torch.Tensor, up_res: int, block: int = 16,
            quant=None) -> torch.Tensor:
    """(Z, Y, X, 4) float32 → (Z·s, Y·s, X·s, 1) float32."""
    lr = lr.to(torch.float32)
    vol = frames.upscale(p1, g1, p2, g2, lr, up_res, block, quant)
    zs, ys, xs, _ = vol.shape
    vel = F.interpolate(lr[..., 1:4].permute(3, 0, 1, 2)[None],
                        size=(zs, ys, xs), mode="trilinear",
                        align_corners=False)[0]          # (3, Zs, Ys, Xs)
    # x-slices (Xs, Ys, Zs, C), channels [d, vz, vy, vx]
    slices = torch.stack([vol[..., 0], vel[2], vel[1], vel[0]], dim=-1)
    del vol, vel
    slices = slices.permute(2, 1, 0, 3)
    out = torch.cat([nets.generator(p3, g3, slices[i:i + block], quant)
                     for i in range(0, xs, block)])       # (Xs, Ys, Zs, 1)
    return out.permute(2, 1, 0, 3)                       # (Zs, Ys, Xs, 1)
