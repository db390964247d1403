"""The port's SSIM and 3D warp vs the JAX package on the CPU.

``ssim_volume`` on 3D volumes, on Z = 1 (2D SSIM) and on axes shorter than
the window (shrunk to the largest odd size), and ``advect_3d`` against
``mpgan_tpu.ops.warp.advect_3d``: the same numpy-seeded inputs through
both, to 1e-6. The port blurs in float64 and JAX in float32 at HIGHEST
precision, so the gap is JAX's float32 rounding. On a 128³ gate frame that
rounding reaches 1.5e-4, so there the port is held to the reference's
algorithm run in float64.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from mpgan_torch.io import uni
from mpgan_torch.ops import warp as twarp
from mpgan_torch.utils import metrics as tmetrics
from mpgan_tpu.infer import assemble as jassemble
from mpgan_tpu.models import generator as jgen
from mpgan_tpu.ops import warp as jwarp
from mpgan_tpu.utils import metrics as jmetrics

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")


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


def _jax_two_pass(name1, name2, sim, frame):
    """JAX's 4x two-pass output of a bundled frame (as tests/test_quality.py
    computes it) and the frame's HR density."""
    def restore(name, g, shape):
        template = g.init(jax.random.PRNGKey(0), jnp.zeros(shape))
        return ocp.StandardCheckpointer().restore(
            os.path.abspath(os.path.join(EXAMPLES, "checkpoints", name)),
            jax.tree.map(ocp.utils.to_shape_dtype_struct, template))
    g1, g2 = jgen.make_pass1(2, 32, 2), jgen.make_pass2(2, 32, 2)
    p1 = restore(name1, g1, (1, 16, 16, 4))
    p2 = restore(name2, g2, (1, 16, 64, 4))
    d = os.path.join(EXAMPLES, "data", sim)
    lr = np.concatenate([uni.readUni(os.path.join(d, f"{s}_{frame:04d}.uni"))[1]
                         for s in ("density_low", "velocity_low")], axis=-1)
    out = jassemble.upscale_volume(g1, p1, g2, p2, jnp.asarray(lr), up_res=4)
    gt = uni.readUni(os.path.join(d, f"density_high_{frame:04d}.uni"))[1]
    return np.asarray(out), gt


def _ssim_reference_float64(fake, real, win_size=11, sigma=1.5):
    """mpgan_tpu.utils.metrics.ssim_volume's algorithm (its window, its
    VALID blur, its moments) on float64 inputs: the reference's answer
    without its float32 rounding."""
    a = jnp.asarray(np.asarray(fake, np.float64).reshape(fake.shape[:3]))
    b = jnp.asarray(np.asarray(real, np.float64).reshape(real.shape[:3]))
    kernels = tuple(jnp.asarray(jmetrics._gaussian_kernel(
        min(win_size, n if n % 2 else n - 1), sigma), jnp.float64)
        for n in a.shape)
    mu_a = jmetrics._blur_valid(a, kernels)
    mu_b = jmetrics._blur_valid(b, kernels)
    var_a = jmetrics._blur_valid(a * a, kernels) - mu_a * mu_a
    var_b = jmetrics._blur_valid(b * b, kernels) - mu_b * mu_b
    cov = jmetrics._blur_valid(a * b, kernels) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    assert ssim_map.dtype == jnp.float64
    return float(jnp.mean(ssim_map))


def test_ssim_on_gate_frame_matches_reference_in_float64():
    """sim_1010c frame 12 at 128³, scored on JAX's two-pass output of the 4x
    GAN fine-tune's EMA chain (the gate with the widest gap). The port is
    held within 1e-6 of the reference's algorithm in float64, run under
    jax.enable_x64 so that no other test sees 64-bit JAX. Against
    mpgan_tpu.utils.metrics itself it is held only within 2e-4: that
    function blurs in float32, and its E[x²] − E[x]² cancels there (it
    reads 1.5e-4 above the float64 value on this frame), so a tighter bound
    would hold the port to JAX's rounding error."""
    out, gt = _jax_two_pass("g1_ganft_ema_4x", "g2_l1_4x", "sim_1010c", 12)
    assert out.shape == gt.shape == (128, 128, 128, 1)
    got = tmetrics.ssim_volume(out, gt)
    with jax.enable_x64(True):
        exact = _ssim_reference_float64(out, gt)
    jax_f32 = jmetrics.ssim_volume(out, gt)
    assert abs(got - exact) <= 1e-6, (got, exact)
    assert abs(got - jax_f32) <= 2e-4, (got, jax_f32)
    assert abs(jax_f32 - exact) > 1e-5, (jax_f32, exact)   # the gap is real
