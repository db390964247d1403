"""The port's semi-Lagrangian warp, its clamped fast path and the temporal
alignment vs the JAX package (CPU, float32), plus the CUDA kernel vs its
plain version on a card (marked ``cuda``; skips without one).

Tolerances: atol 1e-6 against the JAX gather warp (same f32 arithmetic);
2e-5 against the Pallas kernel in interpret mode (its weights are summed
over (2R+2)² taps, as tests/test_warp_pallas.py allows); 1e-4 for
gradients (as tests/test_warp_pallas.py); 1e-5 for the CUDA kernel (FMA
contraction in nvcc's code).

On a machine with a card but without JAX, run the CUDA test alone with
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_warp.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from mpgan_torch.ops import interp as ti
from mpgan_torch.ops import warp as tw
from mpgan_torch.ops import warp_kernel as twk
from mpgan_torch.train import losses as tl
from mpgan_torch.train import loop as tloop

try:
    import jax
    import jax.numpy as jnp

    from mpgan_tpu.ops import interp as ji
    from mpgan_tpu.ops import warp as jw
    from mpgan_tpu.ops import warp_pallas as jwp
    from mpgan_tpu.train import losses as jl
except ImportError:  # a card's machine without JAX runs only the cuda test
    jax = None

ATOL = 1e-6


def _data(B=4, H=32, W=32, vscale=1.5, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.random((B, H, W, 1), dtype=np.float32)
    v = (rng.standard_normal((B, H, W, 2)) * vscale).astype(np.float32)
    return f, v


def _jax_batch(f, v, dt):
    return np.asarray(jax.vmap(jw.advect_2d, in_axes=(0, 0, None))(
        jnp.asarray(f), jnp.asarray(v), dt))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_bilinear_sample_and_grid_match_jax():
    rng = np.random.default_rng(5)
    img = rng.random((3, 9, 7, 2), dtype=np.float32)
    coords = (rng.random((3, 5, 4, 2)) * 14 - 3).astype(np.float32)
    want = np.asarray(jax.vmap(ji.bilinear_sample)(jnp.asarray(img),
                                                   jnp.asarray(coords)))
    got = ti.bilinear_sample(*_t(img, coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ti.grid_coords_2d(9, 7).numpy(),
                                  np.asarray(ji.grid_coords_2d(9, 7)))


@pytest.mark.parametrize("warp", ["plain", "fast"])
def test_matches_xla_in_range(warp):
    f, v = _data(vscale=1.5)
    fn = tw.advect_2d if warp == "plain" else twk.advect_2d_fast
    got = fn(*_t(f, v), 1.0).numpy()
    np.testing.assert_allclose(got, _jax_batch(f, v, 1.0), rtol=0, atol=ATOL)


def test_matches_clamped_reference_out_of_range():
    f, v = _data(vscale=6.0, seed=1)
    want = np.asarray(jwp._clamped_xla_reference(
        jnp.asarray(f), jnp.asarray(v), 1.0, jwp.DEFAULT_MAX_DISP))
    for fn in (twk.advect_2d_clamped_ref, twk.advect_2d_fast):
        got = fn(*_t(f, v), 1.0, twk.DEFAULT_MAX_DISP).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_negative_dt():
    f, v = _data(seed=2)
    got = twk.advect_2d_fast(*_t(f, v), -1.0).numpy()
    np.testing.assert_allclose(got, _jax_batch(f, v, -1.0), rtol=0, atol=ATOL)


def test_zero_velocity_identity():
    f, _ = _data(seed=3)
    v = np.zeros((4, 32, 32, 2), np.float32)
    got = twk.advect_2d_fast(*_t(f, v), 1.0).numpy()
    np.testing.assert_allclose(got, f, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dt,vscale", [(1.0, 1.0), (-1.0, 6.0)])
def test_fast_grads_match_jax_vjp(dt, vscale):
    f, v = _data(B=2, H=16, W=16, vscale=vscale, seed=4)
    g = np.random.default_rng(9).standard_normal((2, 16, 16, 1)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b: jwp._clamped_xla_reference(
        a, b, dt, jwp.DEFAULT_MAX_DISP), jnp.asarray(f), jnp.asarray(v))
    jf, jv = vjp(jnp.asarray(g))
    tf, tv = (t.requires_grad_() for t in _t(f, v))
    out = twk.advect_2d_fast(tf, tv, dt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf), atol=1e-4)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("dt,vscale", [(1.0, 1.5), (-1.0, 6.0)])
def test_pallas_interpret_matches_plain(dt, vscale):
    """The TPU kernel itself (interpret mode) vs the port's plain version."""
    f, v = _data(B=2, H=24, W=40, vscale=vscale, seed=6)
    want = np.asarray(jwp.advect_2d_pallas(jnp.asarray(f), jnp.asarray(v),
                                           dt, interpret=True))
    got = twk.advect_2d_clamped_ref(*_t(f, v), dt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_align_triplet_matches_jax(use_kernel):
    rng = np.random.default_rng(8)
    p, c, n = (rng.random((3, 16, 16, 1), dtype=np.float32) for _ in range(3))
    v = (rng.standard_normal((3, 16, 16, 2)) * 2).astype(np.float32)
    want = np.asarray(jl.align_triplet(*(jnp.asarray(a) for a in (p, c, n, v))))
    got = tl.align_triplet(*_t(p, c, n, v), use_kernel=use_kernel).numpy()
    assert got.shape == (3, 16, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_l1_and_psnr_match_jax():
    rng = np.random.default_rng(10)
    a, b = (rng.random((2, 8, 8, 1), dtype=np.float32) for _ in range(2))
    np.testing.assert_allclose(float(tl.l1_loss(*_t(a, b))),
                               float(jl.l1_loss(a, b)), rtol=1e-6)
    np.testing.assert_allclose(float(tl.psnr(*_t(a, b))),
                               float(jl.psnr(a, b)), rtol=1e-6)


def test_aligned_fakes_matches_jax_composition():
    """loop.py aligned_fakes at pass 1: G on prev/cur/next, velocity
    resized ×s and scaled to HR px, neighbours warped to the centre."""
    from mpgan_torch import convert
    from mpgan_torch.models import generator as TG
    from mpgan_tpu.models import generator as JG

    jg = JG.make_pass1(2, 8, 1)
    params = jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 6, 4)))
    tg = TG.make_pass1(2, 8, 1)
    tg.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(11)
    batch = {k: rng.standard_normal((3, 6, 6, 4)).astype(np.float32) * 0.5
             for k in ("lr", "lr_prev", "lr_next")}
    fakes = [jg.apply(params, jnp.asarray(batch[k]))
             for k in ("lr_prev", "lr", "lr_next")]
    vel = jax.image.resize(jnp.asarray(batch["lr"][..., 1:3]), (3, 24, 24, 2),
                           "linear") * jnp.asarray([4.0, 4.0])
    want = np.asarray(jl.align_triplet(*fakes, vel))
    with torch.no_grad():
        got = tloop.aligned_fakes(
            tg, {k: torch.from_numpy(a) for k, a in batch.items()},
            pass_no=1, stage=2, up_res=4, use_kernel=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_warp_backend_mapping():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tl.use_warp_kernel("auto", cuda) and not tl.use_warp_kernel(
        "auto", cpu)
    assert tl.use_warp_kernel("pallas", cpu)
    assert not tl.use_warp_kernel("xla", cuda)
    with pytest.raises(ValueError):
        tl.use_warp_kernel("triton", cpu)


def test_kernel_wrapper_rejects_cpu_tensors():
    """On CPU tensors the wrapper raises; only advect_2d_fast falls to the
    plain version, and only because the tensors lie on the CPU."""
    f, v = _data(B=1, H=4, W=4)
    before = twk.launches
    with pytest.raises(ValueError, match="CUDA"):
        twk.advect_2d_kernel(*_t(f, v))
    assert twk.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the warp kernel has no CPU mode")
    dev = torch.device("cuda")
    for dt, vscale in ((1.0, 1.5), (-1.0, 1.5), (1.0, 12.0), (-1.0, 0.0)):
        f, v = _data(B=16, H=64, W=64, vscale=vscale, seed=12)
        tf, tv = (t.to(dev) for t in _t(f, v))
        before = twk.launches
        got = twk.advect_2d_kernel(tf, tv, dt)
        torch.cuda.synchronize()
        assert twk.launches == before + 1
        want = twk.advect_2d_clamped_ref(tf, tv, dt)
        assert float((got - want).abs().max()) <= 1e-5, (dt, vscale)
    tf, tv = (t.to(dev).requires_grad_() for t in _t(*_data(B=2, H=16, W=16)))
    twk.advect_2d_fast(tf, tv, 1.0).square().sum().backward()
    rf, rv = (t.detach().clone().requires_grad_() for t in (tf, tv))
    twk.advect_2d_clamped_ref(rf, rv, 1.0).square().sum().backward()
    assert float((tf.grad - rf.grad).abs().max()) <= 1e-4
    assert float((tv.grad - rv.grad).abs().max()) <= 1e-4
