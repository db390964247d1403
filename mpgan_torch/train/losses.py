"""Content losses and the temporal alignment of frame triplets.

Counterpart of ``mpgan_tpu/train/losses.py`` :98-135 (``l1_loss``,
``align_triplet``, ``psnr``); the GAN losses wait for the trainer.

Temporal alignment (tempoGAN §3.2): neighbours are advected to the centre
frame's time with the centre frame's velocity — A(y_{t−1}; +v), y_t,
A(y_{t+1}; −v) — with the velocity in HR pixels, channels (v_w, v_h).
"""

from __future__ import annotations

import torch

from mpgan_torch.ops.warp import advect_2d
from mpgan_torch.ops.warp_kernel import advect_2d_fast


def l1_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(fake - real))


def psnr(fake: torch.Tensor, real: torch.Tensor,
         peak: float = 1.0) -> torch.Tensor:
    mse = torch.mean((fake - real) ** 2)
    return 10.0 * torch.log10(peak ** 2 / torch.clamp(mse, min=1e-12))


def use_warp_kernel(backend: str, device: torch.device) -> bool:
    """``LossConfig.warp_backend`` → whether ``align_triplet`` takes the
    clamped fast warp: ``auto`` for CUDA tensors, ``pallas`` (the JAX
    package's name for its kernel) always, ``xla`` never."""
    if backend == "auto":
        return torch.device(device).type == "cuda"
    if backend in ("pallas", "xla"):
        return backend == "pallas"
    raise ValueError(f"unknown warp backend {backend!r}")


def align_triplet(prev: torch.Tensor, cur: torch.Tensor, nxt: torch.Tensor,
                  vel_hr: torch.Tensor, use_kernel: bool = False,
                  max_disp: int = 8) -> torch.Tensor:
    """Advect neighbours to the centre time; stack as channels for Dt.

    prev/cur/nxt: (B, H, W, 1) densities; vel_hr: (B, H, W, 2) in HR pixel
    units, channels (v_w, v_h). Returns (B, H, W, 3).

    ``use_kernel``: the clamped fast warp (:func:`advect_2d_fast`: the CUDA
    kernel for CUDA tensors), displacement clamped to ±max_disp px.
    """
    if use_kernel:
        warped_prev = advect_2d_fast(prev, vel_hr, 1.0, max_disp)
        warped_next = advect_2d_fast(nxt, vel_hr, -1.0, max_disp)
    else:
        warped_prev = advect_2d(prev, vel_hr, 1.0)
        warped_next = advect_2d(nxt, vel_hr, -1.0)
    return torch.cat([warped_prev, cur.to(warped_prev.dtype), warped_next],
                     dim=-1)
