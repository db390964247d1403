"""Volumetric quality metrics beyond PSNR — counterpart of
``mpgan_tpu/utils/metrics.py``.

SSIM (Wang et al. 2004) generalised to 3D volumes: local means, variances
and covariance under a separable gaussian window (size 11, σ 1.5), one 1-D
filter per volume axis, and the SSIM map averaged over the VALID region (no
padding bias at the borders). An axis shorter than the window uses the
largest odd window that fits (1 = that axis unfiltered), so 2D data
(Z == 1) degrades to plain 2D SSIM.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel(size: int, sigma: float) -> torch.Tensor:
    """The normalised window, computed in float32 as the JAX package
    computes it."""
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _band(n: int, k: torch.Tensor) -> torch.Tensor:
    """(n − len(k) + 1, n) matrix whose row i holds ``k`` at columns
    i … i + len(k) − 1: VALID correlation along one axis as a product."""
    m = len(k)
    rows = torch.arange(n - m + 1)[:, None]
    cols = rows + torch.arange(m)[None, :]
    band = torch.zeros((n - m + 1, n), dtype=k.dtype)
    band[rows.expand(-1, m), cols] = k.expand(n - m + 1, -1)
    return band


def _blur_valid(vols: torch.Tensor, bands: list[torch.Tensor | None]
                ) -> torch.Tensor:
    """Separable VALID filtering of a (N, Z, Y, X) stack, one band matrix
    per volume axis (None = identity on that axis)."""
    out = vols
    for axis, band in enumerate(bands):
        if band is None:
            continue
        out = torch.movedim(torch.tensordot(out, band, dims=([axis + 1],
                                                             [1])),
                            -1, axis + 1)
    return out


def _as_volume(v) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, dtype=np.float32))
    v = v.detach().to(torch.float32)
    return v.reshape(v.shape[:3])


def ssim_volume(fake, real, peak: float = 1.0, win_size: int = 11,
                sigma: float = 1.5) -> float:
    """Mean SSIM between two (Z, Y, X[, 1]) volumes (numpy arrays or
    tensors; a tensor is scored on its own device).

    ``peak`` is the data range (densities live in [0, 1]). Axes shorter
    than ``win_size`` use the largest odd window that fits.

    Precision: the inputs are taken as float32 (the JAX package's input
    precision) and every blur, moment and the map are computed in float64,
    each blur as a product with a banded matrix. The E[x²] − E[x]²
    variance cancels badly under a 10-bit mantissa, so float32 products on
    a card, where PyTorch lets TF32 stand in for float32 by default
    (``torch.backends.cuda.matmul.allow_tf32``, ``cudnn.allow_tf32``),
    would change the score; float64 is never rounded to TF32, so the
    result is full precision whatever those flags say.

    Against the JAX package: ``mpgan_tpu.utils.metrics.ssim_volume`` (and
    so ``scripts/eval.py``) blurs in float32, where the same E[x²] − E[x]²
    cancellation lifts its score. On the 128³ gate frames this function can
    read about 1e-4 below it (1.5e-4 on ``sim_1010c`` frame 12 with the GAN
    fine-tune's EMA chain), and within 1e-6 of the reference's algorithm
    run in float64 (``tests/test_torch_metrics.py``).
    """
    a, b = _as_volume(fake), _as_volume(real)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    bands = []
    for d in a.shape:
        size = min(win_size, d if d % 2 else d - 1)
        bands.append(None if size == 1 else _band(
            d, _gaussian_kernel(size, sigma)).to(torch.float64).to(a.device))
    a, b = a.to(torch.float64), b.to(torch.float64)
    mu_a, mu_b, e_aa, e_bb, e_ab = _blur_valid(
        torch.stack([a, b, a * a, b * b, a * b]), bands)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    var_a = e_aa - mu_a * mu_a
    var_b = e_bb - mu_b * mu_b
    cov = e_ab - mu_a * mu_b
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return float(ssim_map.mean())
