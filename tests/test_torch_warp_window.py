"""The tiled warp forward's window rule, emulated on the CPU (float32),
against the port's plain versions and the JAX package's Pallas kernel.

The kernel (``mpgan_torch/csrc/warp.cu``, ``warp2d_fwd_kernel``) cannot run
here, so this file repeats what a block does, tile by tile, for the tile
that ``warp_kernel.fwd_tile`` picks: it cuts each field's window, the tile
and a halo of ceil(|dt| L) + 1 cells clipped to the image and widened to
multiples of 4 columns (the 16-byte copies), checks that every tap of the
tile falls inside it (the window's address does not depend on the
velocity), gathers the taps from the window alone, and places the tile's
output (for a triplet the staged (pixel, 3) rows, cur in the middle). One
thread per pixel, the tile (0, 0), is the window of the whole image.

Held: the emulation equals ``advect_2d_clamped_ref`` and
``align_triplet_ref`` within 1e-6 (the same float32 arithmetic in another
order), and the JAX ``advect_2d_pallas`` in interpret mode within 2e-5 (its
weights are summed over (2R+2)² taps, as tests/test_torch_warp.py allows;
there with a clamp of 3 cells, whose compile is short), at velocity scales
1.5, 12 (beyond the clamp) and 0, dt ±1 and 0.5; the
tile rule's choice and block counts at the trainer's B=16 64² and at
B=256 256², and the shared memory a tiled block asks for.
"""

import math

import numpy as np
import pytest
import torch

from mpgan_torch.ops import warp_kernel as twk

try:
    import jax.numpy as jnp

    from mpgan_tpu.ops import warp_pallas as jwp
except ImportError:  # pragma: no cover - the JAX package is the reference
    jnp = None

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

R = twk.DEFAULT_MAX_DISP
F32 = torch.float32
SMEM_BUDGET = 112 * 1024  # warp.cu kFwdSmemBudget: two blocks per SM


def _data(b, h, w, vscale, seed=0):
    """prev, cur, nxt (B, H, W, 1), vel (B, H, W, 2), float32."""
    rng = np.random.default_rng(seed)
    f = [rng.random((b, h, w, 1), dtype=np.float32) for _ in range(3)]
    v = (rng.standard_normal((b, h, w, 2)) * vscale).astype(np.float32)
    return [torch.from_numpy(a) for a in (*f, v)]


def _halo(dts, lim: float) -> int:
    """ceil(|dt| L) + 1 in float32, as the launcher computes it."""
    reach = max(float(np.float32(abs(np.float32(dt))) * np.float32(lim))
                for dt in dts)
    return math.ceil(min(reach, 1e6)) + 1


def _window(oy, ox, th, tw, h, w, halo):
    """(rows, columns) of a tile's window: the tile and the halo, clipped
    to the image, its columns widened to multiples of 4 when W % 4 == 0."""
    sy0, sy1 = max(oy - halo, 0), min(oy + th + halo, h)
    sx0, sx1 = max(ox - halo, 0), min(ox + tw + halo, w)
    if w % 4 == 0:
        sx0, sx1 = sx0 & ~3, min((sx1 + 3) & ~3, w)
    return slice(sy0, sy1), slice(sx0, sx1)


def _warp_tile(win, rows, cols, vel, oy, ox, dt, lim, h, w):
    """The warp of one tile (B, th, tw) from its window ``win``
    (B, sh, sw): locate's arithmetic, the taps gathered from the window."""
    b, th, tw, _ = vel.shape
    dt32 = torch.tensor(dt, dtype=F32)
    xs = torch.arange(ox, ox + tw, dtype=F32)[None, None, :]
    ys = torch.arange(oy, oy + th, dtype=F32)[None, :, None]
    px = (xs - dt32 * vel[..., 0].clamp(-lim, lim)).clamp(0, w - 1)
    py = (ys - dt32 * vel[..., 1].clamp(-lim, lim)).clamp(0, h - 1)
    x0, y0 = px.floor().long(), py.floor().long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    fx, fy = px - x0.to(F32), py - y0.to(F32)
    wy, wx = rows.start, cols.start
    for t, lo, n in ((y0, wy, win.shape[1]), (y1, wy, win.shape[1]),
                     (x0, wx, win.shape[2]), (x1, wx, win.shape[2])):
        assert int((t - lo).min()) >= 0 and int((t - lo).max()) < n
    flat = win.reshape(b, -1)
    sw = win.shape[2]

    def tap(yy, xx):
        return flat.gather(1, ((yy - wy) * sw + (xx - wx)).reshape(b, -1)
                           ).reshape(b, th, tw)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x1) * fx
    bot = tap(y1, x0) * (1 - fx) + tap(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def emulate(fields, dts, vel, max_disp, tile, cur=None):
    """The forward kernel, block by block, for ``tile`` ((0, 0): one
    thread per pixel, whose window is the whole image) → (B, H, W, 1), or
    (B, H, W, 3) with ``cur`` for a triplet."""
    b, h, w, _ = vel.shape
    th, tw = tile if tile != (0, 0) else (h, w)
    lim = float(np.float32(max_disp / max(abs(dts[0]), 1e-9)))
    halo = _halo(dts, lim) if tile != (0, 0) else 0
    out = torch.empty((b, h, w, 3 if cur is not None else 1), dtype=F32)
    for oy in range(0, h, th):
        for ox in range(0, w, tw):
            ty, tx = min(th, h - oy), min(tw, w - ox)
            rows, cols = _window(oy, ox, ty, tx, h, w, halo)
            v = vel[:, oy:oy + ty, ox:ox + tx]
            warped = [_warp_tile(f[:, rows, cols, 0], rows, cols, v, oy, ox,
                                 dt, lim, h, w) for f, dt in zip(fields, dts)]
            tile_out = out[:, oy:oy + ty, ox:ox + tx]
            if cur is None:
                tile_out[..., 0] = warped[0]
            else:  # the staged (pixel, 3) rows
                tile_out[..., 0] = warped[0]
                tile_out[..., 1] = cur[:, oy:oy + ty, ox:ox + tx, 0]
                tile_out[..., 2] = warped[1]
    return out


SHAPES = ((2, 70, 132), (3, 37, 45))  # partial tiles; W % 4 == 0 and not


@pytest.mark.parametrize("tile", [twk.FWD_TILE, (0, 0), (16, 32)])
@pytest.mark.parametrize("vscale", [1.5, 12.0, 0.0])
def test_tiled_forward_matches_plain(tile, vscale):
    """Single-field (dt ±1, 0.5) and triplet forwards, emulated block by
    block, equal the plain versions within 1e-6."""
    for b, h, w in SHAPES:
        p, c, n, v = _data(b, h, w, vscale, seed=h)
        for dt in (1.0, -1.0, 0.5):
            got = emulate([p], [dt], v, R, tile)
            want = twk.advect_2d_clamped_ref(p, v, dt)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        got = emulate([p, n], [1.0, -1.0], v, R, tile, cur=c)
        torch.testing.assert_close(got, twk.align_triplet_ref(p, c, n, v),
                                   rtol=0, atol=1e-6)


def test_tiles_the_rule_picks_match_plain():
    """The tile fwd_tile picks at B=256 256² and at the trainer's B=16
    64², on two images of each size; a clamp of 40 cells widens the
    halo."""
    for (b, h, w), max_disp in (((256, 256, 256), R), ((16, 64, 64), R),
                                ((256, 256, 256), 40)):
        p, c, n, v = _data(2, h, w, 3.0, seed=w)
        for fields in (1, 2):
            tile = twk.fwd_tile(b, h, w, fields)
            if fields == 1:
                got = emulate([p], [-1.0], v, max_disp, tile)
                want = twk.advect_2d_clamped_ref(p, v, -1.0, max_disp)
            else:
                got = emulate([p, n], [1.0, -1.0], v, max_disp, tile, cur=c)
                want = twk.align_triplet_ref(p, c, n, v, max_disp)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.skipif(jnp is None, reason="needs the JAX package")
@pytest.mark.parametrize("dt", [1.0, -1.0, 0.5])
def test_tiled_forward_matches_pallas_interpret(dt):
    """The emulation against the TPU kernel itself (interpret mode), at
    velocity scales 1.5, 12 and 0 in one batch. A clamp of 3 cells keeps
    the kernel's (2R+2)² unrolled slices, and its compile, small (about 1 s
    a dt against 5-6 s at 8); 12 is still far beyond it."""
    max_disp = 3
    batches = [_data(2, 24, 40, vscale, seed=int(vscale) + 6)
               for vscale in (1.5, 12.0, 0.0)]
    p, v = (torch.cat([d[i] for d in batches]) for i in (0, 3))
    want = np.asarray(jwp.advect_2d_pallas(
        jnp.asarray(p.numpy()), jnp.asarray(v.numpy()), dt, max_disp,
        interpret=True))
    for tile in ((8, 16), (0, 0)):
        got = emulate([p], [dt], v, max_disp, tile).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_tile_rule_block_counts():
    """One thread per pixel at the trainer's B=16 64² (a latency-bound
    partial wave: 256 blocks of 256 threads), 32x64 tiles at B=256 256²
    (8192 blocks); the windows of a 32x64 tile fit the shared memory
    budget at the trainer's clamp, three triplet blocks per SM."""
    for fields in (1, 2):
        assert twk.fwd_tile(16, 64, 64, fields) == (0, 0)
        assert twk.fwd_tile(256, 256, 256, fields) == twk.FWD_TILE == (32, 64)
        assert 16 * 64 * 64 // 256 == 256
        th, tw = twk.FWD_TILE
        blocks = 256 * (256 // th) * (256 // tw)
        assert blocks == 8192 >= twk.FWD_MIN_BLOCKS[fields]
        assert 16 * -(-64 // th) * -(-64 // tw) < twk.FWD_MIN_BLOCKS[fields]
        # the launcher's shared memory: the velocity tile, (a triplet's
        # output tile,) and each field's widest window rounded to 4 floats
        halo = _halo([1.0], float(R))
        win = min(th + 2 * halo, 256) * min(tw + 2 * halo + 6, 256)
        smem = (th * tw * 8 + (th * tw * 12 if fields == 2 else 0)
                + fields * (-(-win // 4) * 4) * 4)
        assert smem <= SMEM_BUDGET
        assert 228 * 1024 // (smem + 1024) == (6 if fields == 1 else 3)
    # the triplet needs more waves than one field before tiles pay
    assert twk.fwd_tile(64, 256, 256, 1) == (32, 64)
    assert twk.fwd_tile(64, 256, 256, 2) == (0, 0)
