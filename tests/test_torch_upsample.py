"""The port's linear upsampling vs jax.image.resize (CPU, float32).

Tolerance: atol 1e-6 — the same two-tap weights (dyadic, exact in f32),
summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch.ops import upsample as tu
from mpgan_tpu.ops.upsample import linear_up_conv

ATOL = 1e-6


@pytest.mark.parametrize("n", [1, 2, 3, 16, 33])
@pytest.mark.parametrize("axis", [1, 2])
def test_per_stage_2x_matches_resize(n, axis):
    rng = np.random.default_rng(7)
    shape = (2, n, 5, 3) if axis == 1 else (2, 5, n, 3)
    x = rng.standard_normal(shape).astype(np.float32)
    fh, fw = (2, 1) if axis == 1 else (1, 2)
    got = tu.upsample_2d(torch.from_numpy(x), fh, fw).numpy()
    out_shape = list(shape)
    out_shape[axis] *= 2
    want = np.asarray(jax.image.resize(jnp.asarray(x), out_shape, "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("axis", [1, 2])
def test_one_shot_matches_resize_and_linear_up_conv(s, axis):
    """One-shot s× (the global skip) — NOT iterated 2× — at both edges."""
    x = np.random.RandomState(0).randn(3, 12, 10, 4).astype(np.float32)
    fh, fw = (s, 1) if axis == 1 else (1, s)
    got = tu.upsample_any(torch.from_numpy(x), fh, fw).numpy()
    shape = list(x.shape)
    shape[axis] *= s
    want = np.asarray(jax.image.resize(jnp.asarray(x), shape, "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    conv = np.asarray(linear_up_conv(jnp.asarray(x), axis, s))
    np.testing.assert_allclose(got, conv, rtol=0, atol=1e-5)
    # the edge samples: the first/last s/2 outputs read the edge value
    sl = [slice(None)] * 4
    for j in list(range(s // 2)) + [x.shape[axis] * s - 1 - j
                                     for j in range(s // 2)]:
        sl[axis] = j
        np.testing.assert_allclose(got[tuple(sl)], want[tuple(sl)],
                                   rtol=0, atol=ATOL)


@pytest.mark.parametrize("fh,fw", [(4, 4), (8, 8), (8, 1), (4, 1), (1, 4),
                                   (2, 2)])
def test_anisotropic_one_shot_matches_resize(fh, fw):
    x = np.random.RandomState(1).randn(3, 12, 10, 4).astype(np.float32)
    got = tu.upsample_any(torch.from_numpy(x), fh, fw).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, 12 * fh, 10 * fw, 4),
                                       "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("target", [(5, 12, 16), (20, 12, 16)])
def test_resize_volume_matches_resize(target):
    """Velocity staging: per-plane bilinear (pass 2) and trilinear (pass 3)."""
    v = np.random.default_rng(2).standard_normal((5, 3, 4, 3)).astype(
        np.float32)
    got = tu.resize_volume(torch.from_numpy(v), target).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(v), (*target, 3), "linear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_per_stage_factor_out_of_range_raises():
    with pytest.raises(ValueError):
        tu.upsample_2d(torch.zeros(1, 4, 4, 1), 4, 1)
