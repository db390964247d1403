"""The warp backward kernel's fixed-point sums, emulated on the CPU, and
(marked ``cuda``; skips without a card) the kernels' repeat check.

The kernel (``mpgan_torch/csrc/warp.cu``) cannot run here, so this file
repeats its accumulation rule in torch, tile by tile, for the tile that
``warp_kernel.bwd_tile`` picks: the window (the tile and a halo of
ceil(|dt| L) + 1, clipped to the image), M = max |g| over it, the exponent
e = clamp(30 - E, -126, 127) for M < 2^E, each float32 term g 2^e w_y w_x
rounded to an integer (half to even, as ``__float2int_rn``), the terms
summed exactly with ``index_add_`` into int64 cells (the kernel's low and
high 32-bit words with carries), and each cell scaled back once to
float32.

Held: the result within 1e-6 of M of the float64 sum of the same float32
terms (the budget: at most (2 halo)^2 terms per cell, each off by at
most 2^-30 M); the headroom (every term within 2^30, an int; every cell
sum far from 2^63; at most (2 halo)^2 nonzero terms in a cell); the
emulation within 1e-4 of the port's plain gradient and of JAX's VJP (the
tolerance of every warp gradient).

On a machine with a card but without JAX, run the CUDA test alone with
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_warp_fixedpoint.py -m cuda``.
"""

import math

import numpy as np
import pytest
import torch

from mpgan_torch.ops import warp_kernel as twk

try:
    import jax
    import jax.numpy as jnp

    from mpgan_tpu.ops import warp_pallas as jwp
except ImportError:  # a card's machine without JAX runs only the cuda test
    jax = None

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

R = twk.DEFAULT_MAX_DISP
F32 = torch.float32


def _data(b, h, w, vscale, gscale=1.0, seed=0):
    """field (B, H, W, 1), vel (B, H, W, 2), g (B, H, W, 1), float32."""
    rng = np.random.default_rng(seed)
    f = rng.random((b, h, w, 1), dtype=np.float32)
    v = (rng.standard_normal((b, h, w, 2)) * vscale).astype(np.float32)
    g = (rng.standard_normal((b, h, w, 1)) * gscale).astype(np.float32)
    return torch.from_numpy(f), torch.from_numpy(v), torch.from_numpy(g)


def _locate(vel, dt, lim):
    """The kernel's ``locate`` over (B, H, W): x0, x1, y0, y1 (int64), fx,
    fy (float32)."""
    _, h, w, _ = vel.shape
    xs = torch.arange(w, dtype=F32)[None, None, :]
    ys = torch.arange(h, dtype=F32)[None, :, None]
    px = (xs - dt * vel[..., 0].clamp(-lim, lim)).clamp(0, w - 1)
    py = (ys - dt * vel[..., 1].clamp(-lim, lim)).clamp(0, h - 1)
    x0, y0 = px.floor().long(), py.floor().long()
    return (x0, (x0 + 1).clamp(max=w - 1), y0, (y0 + 1).clamp(max=h - 1),
            px - x0.to(F32), py - y0.to(F32))


def _exponent(m: float) -> int:
    """The kernel's exponent for max |g| = m over a window."""
    if m == 0.0:
        return 0
    return min(max(30 - math.frexp(m)[1], -126), 127)


def emulate_bwd(g, vel, dt=1.0, max_disp=R):
    """The kernel's field gradient for g (B, H, W, 1) → (float32 result,
    float64 sum of the same float32 terms, per-block headroom records)."""
    b, h, w, _ = vel.shape
    lim = float(np.float32(max_disp / max(abs(dt), 1e-9)))
    halo = math.ceil(min(abs(dt) * lim, 1e6)) + 1
    th, tw = twk.bwd_tile(b, h, w, 1)
    x0, x1, y0, y1, fx, fy = _locate(vel, dt, lim)
    g = g[..., 0]
    out = torch.empty((b, h, w), dtype=F32)
    exact = torch.empty((b, h, w), dtype=torch.float64)
    records = []
    for bi in range(b):
        for oy in range(0, h, th):
            for ox in range(0, w, tw):
                ty, tx = min(th, h - oy), min(tw, w - ox)
                sy, sx = max(oy - halo, 0), max(ox - halo, 0)
                ey = min(oy + ty - 1 + halo, h - 1) + 1
                ex = min(ox + tx - 1 + halo, w - 1) + 1
                win = (bi, slice(sy, ey), slice(sx, ex))
                gw = g[win].reshape(-1)
                e = _exponent(float(gw.abs().max()))
                scale = torch.tensor(2.0 ** e, dtype=F32)
                gs = gw * scale
                fyw, fxw = fy[win].reshape(-1), fx[win].reshape(-1)
                gt, gb = gs * (1 - fyw), gs * fyw
                taps = ((y0, x0, gt * (1 - fxw), 1 - fyw, 1 - fxw),
                        (y0, x1, gt * fxw, 1 - fyw, fxw),
                        (y1, x0, gb * (1 - fxw), fyw, 1 - fxw),
                        (y1, x1, gb * fxw, fyw, fxw))
                total = torch.zeros(ty * tx, dtype=torch.int64)
                count = torch.zeros(ty * tx, dtype=torch.int64)
                ref = torch.zeros(ty * tx, dtype=torch.float64)
                q_max = 0
                for ys, xs, term, wy, wx in taps:
                    r = ys[win].reshape(-1) - oy
                    cc = xs[win].reshape(-1) - ox
                    inside = (r >= 0) & (r < ty) & (cc >= 0) & (cc < tx)
                    cell = (r * tx + cc)[inside]
                    q = term[inside].round().to(torch.int64)
                    q_max = max(q_max, int(q.abs().max()) if q.numel() else 0)
                    total.index_add_(0, cell, q)
                    count.index_add_(0, cell, (q != 0).long())
                    ref.index_add_(0, cell, (gw.double() * wy.double()
                                             * wx.double())[inside])
                tile = (bi, slice(oy, oy + ty), slice(ox, ox + tx))
                out[tile] = (total.to(F32) * torch.tensor(2.0 ** -e, dtype=F32)
                             ).reshape(ty, tx)
                exact[tile] = ref.reshape(ty, tx)
                records.append({"q_max": q_max, "halo": halo,
                                "sum": int(total.abs().max()),
                                "count": int(count.max())})
    return out[..., None], exact[..., None], records


def _plain_grad(field, vel, g, dt):
    f = field.clone().requires_grad_()
    out = twk.advect_2d_clamped_ref(f, vel, dt)
    return torch.autograd.grad(out, f, g)[0]


CASES = {  # name: (B, H, W, vscale, g scale, dt)
    "trainer_shape": (2, 64, 64, 1.5, 1.0, 1.0),
    "border_pileup": (2, 64, 64, 12.0, 1.0, -1.0),
    "g_zero": (2, 40, 36, 1.5, 0.0, 1.0),
    "g_tiny": (2, 40, 36, 1.5, 1e-20, -1.0),
    "g_huge": (2, 40, 36, 12.0, 1e20, 1.0),
    "odd_sizes": (3, 37, 45, 12.0, 1.0, 1.0),
    "smaller_than_tile": (3, 10, 13, 1.5, 1.0, -1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixed_point_sum_matches_exact_sum(case):
    b, h, w, vscale, gscale, dt = CASES[case]
    field, vel, g = _data(b, h, w, vscale, gscale, seed=len(case))
    got, exact, records = emulate_bwd(g, vel, dt)
    m = float(g.abs().max())
    assert float((got.double() - exact).abs().max()) <= 1e-6 * m, case
    if gscale == 0.0:
        assert not got.any()
    for rec in records:  # every term an int, no cell sum near overflow
        assert rec["q_max"] <= 2 ** 30
        assert rec["count"] <= (2 * rec["halo"]) ** 2
        assert rec["sum"] < rec["count"] * 2 ** 30 + 1 < 2 ** 62
    # and the rule is the plain gradient's, to the gradients' tolerance
    # (scaled with g)
    want = _plain_grad(field, vel, g, dt)
    assert float((got - want).abs().max()) <= 1e-4 * gscale, case


def test_fixed_point_on_64_tiles_matches_jax_vjp():
    """A batch large enough for one field's 64x64 tile (4 tiles per 128x128
    image, 264 blocks): the emulation against JAX's VJP of the clamped
    reference, the custom_vjp backward of the TPU kernel's wrapper."""
    b, h, w = 66, 128, 128
    assert twk.bwd_tile(b, h, w, 1) == (64, 64)
    field, vel, g = _data(b, h, w, 1.5, seed=3)
    got, exact, records = emulate_bwd(g, vel, 1.0)
    m = float(g.abs().max())
    assert float((got.double() - exact).abs().max()) <= 1e-6 * m
    _, vjp = jax.vjp(lambda a: jwp._clamped_xla_reference(
        a, jnp.asarray(vel.numpy()), 1.0, R), jnp.asarray(field.numpy()))
    want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_tile_rule_fills_the_card():
    """The largest tiles only when they give two blocks per SM, else 16x32:
    the trainer's B=16 64x64 runs 128 blocks, not 16."""
    assert twk.bwd_tile(256, 256, 256, 1) == (64, 64)
    assert twk.bwd_tile(256, 256, 256, 2) == (32, 64)
    assert twk.bwd_tile(16, 64, 64, 1) == twk.bwd_tile(16, 64, 64, 2) == (
        16, 32)
    assert twk.bwd_tile(65, 128, 128, 1) == (16, 32)  # 260 blocks of 64x64
    assert twk.bwd_tile(1, 10, 13, 2) == (16, 32)
    for b, h, w in ((16, 64, 64), (4, 256, 256), (256, 256, 256)):
        for fields in (1, 2):
            th, tw = twk.bwd_tile(b, h, w, fields)
            blocks = b * -(-h // th) * -(-w // tw)
            assert (blocks >= twk.BWD_MIN_BLOCKS
                    or (th, tw) == twk.BWD_TILES[fields][-1])
            assert blocks >= 128


@pytest.mark.cuda
def test_cuda_backwards_repeat_bit_for_bit():
    """Five calls of each backward kernel on the same inputs give the same
    bits, on 16x32 tiles (the trainer's shape) and the largest tiles, with
    the border pile-up of vscale 12 and g scaled to the exponent's ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the warp kernels have no CPU mode")
    dev = torch.device("cuda")
    for (b, h, w), vscale, gscale in (((16, 64, 64), 1.5, 1.0),
                                      ((16, 64, 64), 12.0, 1e20),
                                      ((3, 200, 130), 12.0, 1.0),
                                      ((66, 128, 128), 12.0, 1.0),
                                      ((4, 64, 64), 1.5, 1e-20)):
        field, vel, g1 = (t.to(dev) for t in _data(b, h, w, vscale, gscale))
        g3 = torch.cat([g1, g1 * 0.5, -g1], dim=-1)
        g3 = g3.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # NCHW
        nxt = field.flip(1).contiguous()
        single = [twk.advect_2d_kernel_bwd(g1, field, vel, -1.0, R, True, True)
                  for _ in range(5)]
        triplet = [twk.align_triplet_kernel_bwd(g3, field, nxt, vel, R, True,
                                                True) for _ in range(5)]
        torch.cuda.synchronize()
        for runs in (single, triplet):
            for run in runs[1:]:
                for a, z in zip(run, runs[0]):
                    assert torch.equal(a, z), (b, h, w, vscale, gscale)
        want = _plain_grad(field, vel, g1, -1.0)
        assert float((single[0][0] - want).abs().max()) <= 1e-4 * gscale
