"""The fused triplet alignment and the warp's backward vs the JAX package
(CPU, float32), the wiring of the autograd Functions around the kernels,
and the CUDA kernels vs their plain versions on a card (marked ``cuda``;
skips without one).

The JAX side of a triplet is ``_clamped_xla_reference`` at dt = +1 and −1
with cur between them (``align_triplet(use_pallas=True)``'s function).
Tolerances: 1e-6 for values (the same f32 arithmetic); 1e-4 for gradients
(as tests/test_warp_pallas.py holds the VJP); on the card 1e-5 for the
forward kernels (FMA contraction in nvcc's code) and 1e-4 for the
backward kernel, which sums each cell's contributions as fixed-point
integers (the same bits on every run) and rounds once to float32 at the
end.

At zero velocity every backtrace lies exactly on its cell, and on the
image's first row and column exactly on the border clamp's lower bound.
There torch's clamp passes the whole gradient (its mask is inclusive),
while JAX's ``jnp.clip`` passes half (``lax.max`` splits a tie). The port
follows torch; the test holds the velocity gradient there at twice JAX's.

On a machine with a card but without JAX, run the CUDA test alone with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_warp_triplet.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from mpgan_torch.ops import warp_kernel as twk
from mpgan_torch.train import losses as tl

try:
    import jax
    import jax.numpy as jnp

    from mpgan_tpu.ops import warp_pallas as jwp
except ImportError:  # a card's machine without JAX runs only the cuda test
    jax = None

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

R = twk.DEFAULT_MAX_DISP


def _data(B=3, H=20, W=24, vscale=1.5, seed=0):
    """prev, cur, nxt (B, H, W, 1), vel (B, H, W, 2), and a gradient of the
    (B, H, W, 3) output, float32."""
    rng = np.random.default_rng(seed)
    p, c, n = (rng.random((B, H, W, 1), dtype=np.float32) for _ in range(3))
    v = (rng.standard_normal((B, H, W, 2)) * vscale).astype(np.float32)
    g = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    return p, c, n, v, g


def _jax_triplet(p, c, n, v):
    return jnp.concatenate([jwp._clamped_xla_reference(p, v, 1.0, R), c,
                            jwp._clamped_xla_reference(n, v, -1.0, R)],
                           axis=-1)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("vscale", [1.5, 6.0, 0.0])
def test_align_triplet_fast_matches_jax(vscale):
    p, c, n, v, _ = _data(vscale=vscale, seed=1)
    want = np.asarray(_jax_triplet(*(jnp.asarray(a) for a in (p, c, n, v))))
    got = twk.align_triplet_fast(*_t(p, c, n, v)).numpy()
    assert got.shape == (3, 20, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    via_loss = tl.align_triplet(*_t(p, c, n, v), use_kernel=True).numpy()
    np.testing.assert_array_equal(via_loss, got)


@pytest.mark.parametrize("vscale", [1.5, 6.0, 0.0])
def test_align_triplet_fast_grads_match_jax_vjp(vscale):
    p, c, n, v, g = _data(B=2, H=16, W=20, vscale=vscale, seed=2)
    if vscale == 0.0:
        v[:] = 0.0
    _, vjp = jax.vjp(_jax_triplet, *(jnp.asarray(a) for a in (p, c, n, v)))
    want = [np.array(x) for x in vjp(jnp.asarray(g))]
    ins = [t.requires_grad_() for t in _t(p, c, n, v)]
    got = [t.numpy() for t in torch.autograd.grad(
        twk.align_triplet_fast(*ins), ins, torch.from_numpy(g))]
    for name, a, b in zip(("prev", "cur", "nxt"), got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
    if vscale == 0.0:
        # the border tie: full gradient in torch, half in JAX
        tie = np.zeros(v.shape, bool)
        tie[:, :, 0, 0] = tie[:, 0, :, 1] = True
        assert np.abs(want[3][tie]).max() > 1e-2
        want[3][tie] *= 2.0
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-4)


def _plain_kernels(monkeypatch):
    """Replace the kernel wrappers with the plain versions, counting as the
    wrappers count; returns the list of backward calls' flags."""
    flags = []

    def fwd(p, c, n, v, max_disp=R):
        twk.launches += 1
        return twk.align_triplet_ref(p, c, n, v, max_disp)

    def bwd(g, p, n, v, max_disp=R, field_grads=True, vel_grad=False):
        twk.bwd_launches += 1
        flags.append((field_grads, vel_grad))
        ins = [t.detach().requires_grad_() for t in (p, n, v)]
        with torch.enable_grad():
            out = twk.align_triplet_ref(ins[0], torch.zeros_like(p), ins[1],
                                        ins[2], max_disp)
            dp, dn, dv = torch.autograd.grad(out, ins, g)
        return (dp if field_grads else None, dn if field_grads else None,
                dv if vel_grad else None)

    monkeypatch.setattr(twk, "align_triplet_kernel", fwd)
    monkeypatch.setattr(twk, "align_triplet_kernel_bwd", bwd)
    return flags


@pytest.mark.parametrize("needs", ["fields", "vel", "none"])
def test_align_triplet_function_wiring(monkeypatch, needs):
    """AlignTripletFast with the kernels replaced by their plain versions:
    one forward and (where any gradient is asked for) one backward launch,
    the backward asked only for what autograd needs, cur's gradient a view
    of the incoming one, every gradient equal to the plain autograd's."""
    flags = _plain_kernels(monkeypatch)
    p, c, n, v, g = _data(B=2, H=12, W=10, vscale=3.0, seed=3)
    ins = _t(p, c, n, v)
    want_grad = {"fields": (True, True, True, False),
                 "vel": (False, False, False, True),
                 "none": (False,) * 4}[needs]
    for t, w in zip(ins, want_grad):
        t.requires_grad_(w)
    n0, nb0 = twk.launches, twk.bwd_launches
    out = twk.AlignTripletFast.apply(*ins, R)
    assert twk.launches - n0 == 1
    ref_in = [t.detach().clone().requires_grad_(w)
              for t, w in zip(ins, want_grad)]
    ref = twk.align_triplet_ref(*ref_in)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().numpy())
    if needs == "none":
        assert not out.requires_grad and not flags
        return
    got = torch.autograd.grad(out, [t for t in ins if t.requires_grad],
                              torch.from_numpy(g))
    want = torch.autograd.grad(ref, [t for t in ref_in if t.requires_grad],
                               torch.from_numpy(g))
    assert twk.bwd_launches - nb0 == 1
    assert flags == [(needs == "fields", needs == "vel")]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fn", ["align_triplet_kernel",
                                "align_triplet_kernel_bwd"])
def test_triplet_wrappers_reject_cpu_tensors(fn):
    """On CPU tensors the wrappers raise and count nothing; only
    align_triplet_fast takes the plain version, and only because the
    tensors lie on the CPU."""
    p, c, n, v, g = _t(*_data(B=1, H=4, W=4))
    before = (twk.launches, twk.bwd_launches)
    args = ((p, c, n, v) if fn == "align_triplet_kernel"
            else (g, p, n, v))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(twk, fn)(*args)
    assert (twk.launches, twk.bwd_launches) == before


@pytest.mark.cuda
def test_cuda_triplet_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the warp kernels have no CPU mode")
    dev = torch.device("cuda")
    # 64² is one block per image in the backward, 70x130 the tiled form
    for (B, H, W), vscale in (((16, 64, 64), 1.5), ((16, 64, 64), 12.0),
                              ((3, 70, 130), 1.5), ((4, 64, 64), 0.0)):
        p, c, n, v, g = (t.to(dev) for t in _t(*_data(B, H, W, vscale, 5)))
        if vscale == 0.0:
            v.zero_()
        g = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # NCHW
        n0, nb0 = twk.launches, twk.bwd_launches
        ins = [t.clone().requires_grad_() for t in (p, c, n, v)]
        out = twk.align_triplet_fast(*ins)
        got = torch.autograd.grad(out, ins, g)
        torch.cuda.synchronize()
        assert (twk.launches - n0, twk.bwd_launches - nb0) == (1, 1)
        ref_in = [t.clone().requires_grad_() for t in (p, c, n, v)]
        ref = twk.align_triplet_ref(*ref_in)
        want = torch.autograd.grad(ref, ref_in, g)
        assert float((out - ref).abs().max()) <= 1e-5, (B, H, W, vscale)
        for a, b in zip(got, want):
            assert float((a - b).abs().max()) <= 1e-4, (B, H, W, vscale)
        d_prev, d_nxt, d_vel = twk.align_triplet_kernel_bwd(g, p, n, v)
        assert d_vel is None
        assert float((d_prev - want[0]).abs().max()) <= 1e-4
        assert float((d_nxt - want[2]).abs().max()) <= 1e-4
