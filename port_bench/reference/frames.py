"""Plain float32 reference of a two-pass super-resolved frame.

Pass 1 runs G1 over the xy slices of the LR volume (Z, Y, X, 4); pass 2
runs G2 over the xz slices of the intermediate volume with the LR velocity
linearly resized to its grid (channels [d, vx, vz, vy]); the slices are
transposed back into (Z·s, Y·s, X·s, 1). Slices go through the networks in
blocks, so that a full-size frame fits beside the program's state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference import nets


def _blocks(fn, slices: torch.Tensor, block: int) -> torch.Tensor:
    return torch.cat([fn(slices[i:i + block])
                      for i in range(0, slices.shape[0], block)])


def upscale(p1: dict, g1: dict, p2: dict, g2: dict, lr: torch.Tensor,
            up_res: int, block: int = 16, quant=None) -> torch.Tensor:
    """(Z, Y, X, 4) float32 → (Z·s, Y·s, X·s, 1) float32."""
    lr = lr.to(torch.float32)
    z, y, x, _ = lr.shape
    interm = _blocks(lambda s: nets.generator(p1, g1, s, quant), lr, block)
    ys, xs = y * up_res, x * up_res
    vel = F.interpolate(lr[..., 1:4].permute(0, 3, 1, 2), size=(ys, xs),
                        mode="bilinear", align_corners=False)
    vel = vel.permute(0, 2, 3, 1)                        # (Z, Ys, Xs, 3)
    vol = torch.cat([interm, vel[..., 0:1], vel[..., 2:3], vel[..., 1:2]],
                    dim=-1)
    del interm, vel
    slices = vol.permute(1, 0, 2, 3)                     # (Ys, Z, Xs, 4)
    out = _blocks(lambda s: nets.generator(p2, g2, s, quant), slices, block)
    return out.permute(1, 0, 2, 3)                       # (Zs, Ys, Xs, 1)
