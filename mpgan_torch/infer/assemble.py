"""Full-volume multi-pass inference + slice reassembly.

Counterpart of ``mpgan_tpu/infer/assemble.py`` :29-142 and :278-283:
LR volume (Z, Y, X, C) →
  pass 1: all z-slices (xy planes) through G1 → intermediate
          (Z, Y·s, X·s, 1);
  pass 2: all y-slices (xz planes) of the intermediate volume + the LR
          velocity linearly resized to its grid through G2 → final
          (Z·s, Y·s, X·s, 1);
  pass 3 (optional): x-slices (yz planes) of the final volume through G3.

Channel layouts match the training pipeline: xy slices use [d, vx, vy, vz],
xz slices [d, vx, vz, vy], yz slices [d, vz, vy, vx]. Generators are
:class:`mpgan_torch.models.generator.Generator` modules that own their
parameters. The host-streamed assembly, the dataset sweeps and the mesh
wait for later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from mpgan_torch.ops.upsample import resize_volume


def apply_sliced(apply_fn, slices: torch.Tensor, chunk: int = 0
                 ) -> torch.Tensor:
    """Run a per-slice model over a (N, H, W, C) slice stack.

    chunk = 0 → one batch; otherwise fixed-size chunks, the last one
    zero-padded to the chunk size and trimmed (every call sees one shape),
    written into one preallocated output.
    """
    n = slices.shape[0]
    if chunk <= 0 or chunk >= n:
        return apply_fn(slices)
    out = None
    for i in range(0, n, chunk):
        part = slices[i:i + chunk]
        m = part.shape[0]
        if m < chunk:
            pad = part.new_zeros((chunk - m, *part.shape[1:]))
            part = torch.cat([part, pad])
        res = apply_fn(part)[:m]
        if out is None:
            out = res.new_empty((n, *res.shape[1:]))
        out[i:i + m] = res
    return out


def pass1_volume(gen1, lr_vol: torch.Tensor, stage: int | None = None,
                 chunk: int = 0) -> torch.Tensor:
    """(Z, Y, X, C) → intermediate (Z, Y·s, X·s, 1) via xy slices."""
    return apply_sliced(lambda x: gen1(x, stage=stage), lr_vol, chunk)


def _with_velocity(vol: torch.Tensor, lr_vel: torch.Tensor | None,
                   perm: list[int], dtype: torch.dtype) -> torch.Tensor:
    """Stage ``vol`` in the generator's dtype, with the LR velocity resized
    to its grid (values stay in LR units) and permuted for the slice plane."""
    if lr_vel is None:
        return vol.to(dtype)
    vel = resize_volume(lr_vel.to(dtype), tuple(vol.shape[:3]))[..., perm]
    return torch.cat([vol.to(dtype), vel], dim=-1)


def pass2_volume(gen2, interm: torch.Tensor, lr_vel: torch.Tensor | None,
                 stage: int | None = None, chunk: int = 0) -> torch.Tensor:
    """Intermediate (Z, Ys, Xs, 1) [+ LR velocity (Z, Y, X, 3)] →
    final (Z·s, Ys, Xs, 1) via xz slices (z-axis refinement)."""
    vol_in = _with_velocity(interm, lr_vel, [0, 2, 1], gen2.dtype)
    slices = vol_in.permute(1, 0, 2, 3)              # (Ys, Z, Xs, C)
    out = apply_sliced(lambda x: gen2(x, stage=stage), slices, chunk)
    return out.permute(1, 0, 2, 3)                   # (Zs, Ys, Xs, 1)


def pass3_volume(gen3, vol: torch.Tensor, lr_vel: torch.Tensor | None,
                 chunk: int = 0) -> torch.Tensor:
    """Constant-resolution refinement over yz slices of the full-res volume
    (Zs, Ys, Xs, 1); slice channels [d, v_w=vz, v_h=vy, v_out=vx]."""
    vol_in = _with_velocity(vol, lr_vel, [2, 1, 0], gen3.dtype)
    slices = vol_in.permute(2, 1, 0, 3)              # (Xs, Ys, Zs, C)
    out = apply_sliced(gen3, slices, chunk)
    return out.permute(2, 1, 0, 3)


def upscale_volume(gen1, gen2, lr_vol: torch.Tensor, up_res: int,
                   stage: int | None = None, chunk: int = 0,
                   gen3=None) -> torch.Tensor:
    """Full multi-pass SR: (Z, Y, X, C) LR → (Z·s, Y·s, X·s, 1) HR density.

    lr_vol channels [d, vx, vy, vz] (or density only). Z = 1 (2D data)
    returns the pass-1 output. gen2=None → pass 1 with a nearest z-repeat
    standing in for pass 2; a pass-3 refiner still runs after it.
    """
    interm = pass1_volume(gen1, lr_vol, stage=stage, chunk=chunk)
    if lr_vol.shape[0] == 1:
        return interm
    lr_vel = lr_vol[..., 1:4] if lr_vol.shape[-1] >= 4 else None
    if gen2 is None:
        out = interm.repeat_interleave(up_res, dim=0)
    else:
        out = pass2_volume(gen2, interm, lr_vel, stage=stage, chunk=chunk)
    if gen3 is not None:
        out = pass3_volume(gen3, out, lr_vel, chunk=chunk)
    return out


def psnr_volume(fake, real, peak: float = 1.0) -> float:
    """PSNR in float32 of two volumes (numpy arrays or tensors)."""
    def f32(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu", torch.float32).numpy()
        return np.asarray(a).astype(np.float32, copy=False)
    mse = float(np.mean((f32(fake) - f32(real)) ** 2))
    return float(10.0 * np.log10(peak ** 2 / max(mse, 1e-12)))
