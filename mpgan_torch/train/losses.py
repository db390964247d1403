"""GAN losses, content losses and the temporal alignment of frame triplets.

Counterpart of ``mpgan_tpu/train/losses.py``. Total generator loss:
    L_G = λ_adv·g_adv(Ds(cond, G(x))) + λ_t·g_adv(Dt(aligned G-triplet))
        + λ_L1·‖G(x) − y‖₁ + λ_f·Σ_j ‖F_j(real) − F_j(fake)‖²
with the adversarial family ``sce`` (reference default), ``lsgan``,
``hinge`` and ``wgan``, plus R1 and WGAN-GP penalties.

Temporal alignment (tempoGAN §3.2): neighbours are advected to the centre
frame's time with the centre frame's velocity — A(y_{t−1}; +v), y_t,
A(y_{t+1}; −v) — with the velocity in HR pixels, channels (v_w, v_h).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpgan_torch import tracing
from mpgan_torch.ops.warp import advect_2d
from mpgan_torch.ops.warp_kernel import align_triplet_fast


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean sigmoid cross-entropy against a constant target (0 or 1)."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor,
           label_smooth: float = 0.0, mode: str = "sce") -> torch.Tensor:
    """Discriminator adversarial loss: ``sce`` with one-sided label
    smoothing (real → 1−ε), ``lsgan``, ``hinge`` or ``wgan`` (the last two
    refuse label smoothing, which they would silently ignore)."""
    if mode == "sce":
        return (bce_logits(real_logits, 1.0 - label_smooth)
                + bce_logits(fake_logits, 0.0))
    if mode == "lsgan":
        return 0.5 * (torch.mean((real_logits - (1.0 - label_smooth)) ** 2)
                      + torch.mean(fake_logits ** 2))
    if mode in ("hinge", "wgan"):
        if label_smooth:
            raise ValueError(
                f"labelSmooth {label_smooth} has no effect with ganLoss "
                f"{mode!r} (only sce/lsgan use smoothed targets); refusing "
                f"to silently ignore it")
        if mode == "hinge":
            return (torch.mean(F.relu(1.0 - real_logits))
                    + torch.mean(F.relu(1.0 + fake_logits)))
        return torch.mean(fake_logits) - torch.mean(real_logits)
    raise ValueError(f"unknown ganLoss mode: {mode!r}")


def g_adv_loss(fake_logits: torch.Tensor, mode: str = "sce") -> torch.Tensor:
    if mode == "sce":
        return bce_logits(fake_logits, 1.0)
    if mode == "lsgan":
        return 0.5 * torch.mean((fake_logits - 1.0) ** 2)
    if mode in ("hinge", "wgan"):
        return -torch.mean(fake_logits)
    raise ValueError(f"unknown ganLoss mode: {mode!r}")


def _input_grad_sq(disc_fn, x: torch.Tensor) -> torch.Tensor:
    """Per-sample ‖∇_x Σ disc_fn(x)‖², differentiable (for a penalty)."""
    x = x.detach().to(torch.float32).requires_grad_(True)
    grads, = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    return torch.sum(grads ** 2, dim=tuple(range(1, grads.dim())))


def r1_penalty(disc_fn, real_in: torch.Tensor) -> torch.Tensor:
    """R1 regularizer (Mescheder et al. 2018): E[‖∇_x D(x_real)‖²], the
    gradient of the summed logits w.r.t. the float32 real input. The caller
    scales by γ/2."""
    return torch.mean(_input_grad_sq(disc_fn, real_in))


def gradient_penalty(disc_fn, real_in: torch.Tensor, fake_in: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """WGAN-GP (Gulrajani et al. 2017): E[(‖∇_x̂ D(x̂)‖ − 1)²] on the
    interpolates x̂ = ε·real + (1−ε)·fake, with ε (B, 1, 1, 1) uniform
    [0, 1) drawn by the caller from its generator."""
    x_hat = eps * real_in + (1.0 - eps) * fake_in
    norms = torch.sqrt(_input_grad_sq(disc_fn, x_hat) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def l1_loss(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(fake - real))


def feature_loss(feats_real: list[torch.Tensor],
                 feats_fake: list[torch.Tensor]) -> torch.Tensor:
    """Ds feature-space L2 (tempoGAN §3.3)."""
    total = 0.0
    for fr, ff in zip(feats_real, feats_fake):
        total = total + torch.mean((fr - ff) ** 2)
    return total


def mse(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    return torch.mean((fake - real) ** 2)


def psnr_from_mse(err: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(peak ** 2 / torch.clamp(err, min=1e-12))


def psnr(fake: torch.Tensor, real: torch.Tensor,
         peak: float = 1.0) -> torch.Tensor:
    return psnr_from_mse(mse(fake, real), peak)


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

    ``use_kernel``: the clamped fast warp (:func:`align_triplet_fast`: for
    CUDA tensors one fused kernel launch forward and one backward),
    displacement clamped to ±max_disp px. A span, ``warp.align``
    (:mod:`mpgan_torch.tracing`).
    """
    with tracing.span("warp.align"):
        if use_kernel:
            return align_triplet_fast(prev, cur, nxt, vel_hr, max_disp)
        warped_prev = advect_2d(prev, vel_hr, 1.0)
        warped_next = advect_2d(nxt, vel_hr, -1.0)
        return torch.cat([warped_prev, cur.to(warped_prev.dtype),
                          warped_next], dim=-1)
