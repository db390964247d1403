"""The port's SSIM and 3D warp vs the JAX package on the CPU.

``ssim_volume`` on 3D volumes, on Z = 1 (2D SSIM) and on axes shorter than
the window (shrunk to the largest odd size), and ``advect_3d`` against
``mpgan_tpu.ops.warp.advect_3d``: the same numpy-seeded inputs through
both, to 1e-6. The port blurs in float64 and JAX in float32 at HIGHEST
precision, so the gap is JAX's float32 rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch.ops import warp as twarp
from mpgan_torch.utils import metrics as tmetrics
from mpgan_tpu.ops import warp as jwarp
from mpgan_tpu.utils import metrics as jmetrics

torch.set_num_threads(1)


def _pair(shape, seed, noise=0.05):
    """A smooth-ish volume and a noisy copy of it, in [0, 1]."""
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape).astype(np.float32),
                0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [
    (16, 16, 16, 1),    # 3D, the full 11-wide window
    (1, 24, 20, 1),     # Z = 1: plain 2D SSIM
    (6, 9, 30, 1),      # Z and Y shorter than the window: 5 and 9
    (4, 12, 13),        # no channel axis; Z shrinks to 3
])
def test_ssim_volume_matches_jax(shape):
    a, b = _pair(shape, seed=sum(shape))
    want = jmetrics.ssim_volume(a, b)
    got = tmetrics.ssim_volume(a, b)
    assert abs(got - want) <= 1e-6, (got, want)
    assert tmetrics.ssim_volume(torch.from_numpy(a), b) == got
    assert abs(tmetrics.ssim_volume(a, a) - 1.0) <= 1e-12


def test_ssim_volume_peak_and_shape_mismatch():
    a, b = _pair((12, 12, 12, 1), seed=3)
    want = jmetrics.ssim_volume(a * 4, b * 4, peak=4.0)
    assert abs(tmetrics.ssim_volume(a * 4, b * 4, peak=4.0) - want) <= 1e-6
    with pytest.raises(ValueError, match="shape mismatch"):
        tmetrics.ssim_volume(a, b[:-1])


def test_ssim_volume_bfloat16_tensor_is_widened():
    a, b = _pair((12, 12, 12, 1), seed=4)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    want = jmetrics.ssim_volume(a16.float().numpy(), b)
    assert abs(tmetrics.ssim_volume(a16, b) - want) <= 1e-6


@pytest.mark.parametrize("dt,vscale", [(1.0, 1.5), (-1.0, 3.0), (0.5, 0.0)])
def test_advect_3d_matches_jax(dt, vscale):
    rng = np.random.default_rng(int(vscale * 10) + 1)
    field = rng.random((6, 7, 8, 2), dtype=np.float32)
    vel = (rng.standard_normal((6, 7, 8, 3)) * vscale).astype(np.float32)
    want = np.asarray(jwarp.advect_3d(jnp.asarray(field), jnp.asarray(vel),
                                      dt))
    got = twarp.advect_3d(torch.from_numpy(field), torch.from_numpy(vel),
                          dt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if vscale == 0.0:
        np.testing.assert_array_equal(got, field)
