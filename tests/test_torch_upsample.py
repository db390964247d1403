"""The port's linear upsampling vs jax.image.resize (CPU, float32).

Tolerance: atol 1e-6 — the same two-tap weights (dyadic, exact in f32),
summed in another order. The fixed-order backward: against the autograd
of ``F.interpolate`` and ``jax.vjp`` of the JAX upsample within 1e-6 in
float64 and 1e-5 in float32 (a gradient sums up to 2s products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch.ops import upsample as tu
import torch.nn.functional as F

from mpgan_tpu.ops import upsample as ju
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


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-6), ("float32", 1e-5)])
@pytest.mark.parametrize("fh,fw,h,w", [
    (2, 2, 5, 7), (2, 1, 1, 6), (1, 2, 3, 1),           # per-stage 2×
    (4, 4, 7, 5), (4, 1, 1, 9), (8, 8, 3, 5), (8, 2, 5, 1)])  # one-shot
def test_fixed_backward_matches_interpolate_and_jax_vjp(fh, fw, h, w, dtype,
                                                        tol):
    """The gradient of the port's upsample (slice-and-add, no atomics)
    equals the autograd of F.interpolate and JAX's VJP of ``upsample_2d``
    (factors 1 or 2) or ``upsample_any``; odd sizes and size 1 included."""
    rng = np.random.default_rng(fh * 10 + fw + h)
    x = rng.standard_normal((2, h, w, 3)).astype(dtype)
    g = rng.standard_normal((2, h * fh, w * fw, 3)).astype(dtype)
    xt = torch.from_numpy(x).requires_grad_()
    got, = torch.autograd.grad(tu.upsample_any(xt, fh, fw), xt,
                               torch.from_numpy(g))
    xi = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    ref, = torch.autograd.grad(
        F.interpolate(xi, size=(h * fh, w * fw), mode="bilinear",
                      align_corners=False), xi,
        torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(),
                               ref.permute(0, 2, 3, 1).numpy(),
                               rtol=0, atol=tol)
    up = ((lambda v: ju.upsample_2d(v, fh, fw)) if max(fh, fw) <= 2
          else (lambda v: ju.upsample_any(v, fh, fw)))
    with jax.enable_x64(dtype == "float64"):
        _, vjp = jax.vjp(up, jnp.asarray(x))
        want, = vjp(jnp.asarray(g))
        want = np.asarray(want)
    assert want.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_fixed_backward_is_bitwise_repeatable():
    """Two backward calls on the same inputs give the same bits."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 8, 9, 16)).astype(
        np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((4, 32, 36, 16)).astype(
        np.float32))
    a, b = (torch.autograd.grad(tu.upsample_any(x, 4, 4), x, g)[0]
            for _ in range(2))
    assert torch.equal(a, b)
