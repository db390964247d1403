"""The warp forwards through their dispatcher operators
(``torch.ops.mpgan_warp``, ``mpgan_torch/csrc/warp_ops.cpp``) on a card:
each forward against its plain version, tiled and one thread per pixel;
the operators' refusals; the launch counters; a CUDA graph's replay
against an eager call. Marked ``cuda``: every test skips without a card,
decided inside the test. Imports no JAX, so that a card's machine without
it runs the file alone:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_warp_ops.py -m cuda

Tolerance: 1e-5 against the plain version (FMA contraction in nvcc's
code, as tests/test_torch_warp.py holds the kernel).
"""

import numpy as np
import pytest
import torch

from mpgan_torch.ops import warp_kernel as twk

R = twk.DEFAULT_MAX_DISP


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the warp kernels have no CPU mode")
    return torch.device("cuda")


def _data(b, h, w, vscale, dev, seed=0):
    rng = np.random.default_rng(seed)
    f = [rng.random((b, h, w, 1), dtype=np.float32) for _ in range(3)]
    v = (rng.standard_normal((b, h, w, 2)) * vscale).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (*f, v)]


def _gap(a, b):
    return float((a - b).abs().max())


# the trainer's shape (one thread per pixel), B=256 256² (32x64 tiles),
# partial tiles with W % 4 == 0 and not, forced through both designs
CASES = (((16, 64, 64), None), ((256, 256, 256), None),
         ((3, 70, 132), (32, 64)), ((3, 37, 45), (32, 64)),
         ((16, 64, 64), (32, 64)), ((256, 256, 256), (0, 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tile", CASES)
def test_forwards_match_plain(monkeypatch, shape, tile):
    dev = _card()
    if tile is not None:
        monkeypatch.setattr(twk, "fwd_tile", lambda *_: tile)
        twk._tile_of.cache_clear()
    try:
        for vscale in (1.5, 12.0, 0.0):
            p, c, n, v = _data(*shape, vscale, dev, seed=shape[1])
            for dt in (1.0, -1.0, 0.5):
                got = twk.advect_2d_kernel(p, v, dt)
                want = twk.advect_2d_clamped_ref(p, v, dt)
                assert _gap(got, want) <= 1e-5, (shape, tile, vscale, dt)
            got = twk.align_triplet_kernel(p, c, n, v)
            assert _gap(got, twk.align_triplet_ref(p, c, n, v)) <= 1e-5
        # a clamp of 40: windows too large to stage
        p, c, n, v = _data(*shape, 30.0, dev, seed=1)
        assert _gap(twk.advect_2d_kernel(p, v, 1.0, 40),
                    twk.advect_2d_clamped_ref(p, v, 1.0, 40)) <= 1e-5
        assert _gap(twk.align_triplet_kernel(p, c, n, v, 40),
                    twk.align_triplet_ref(p, c, n, v, 40)) <= 1e-5
    finally:
        twk._tile_of.cache_clear()


@pytest.mark.cuda
def test_unaligned_views_match_plain():
    """Fields and velocity at 4- and 8-byte offsets: 4- and 8-byte copies
    in place of 16-byte ones."""
    dev = _card()
    for shape in ((16, 64, 64), (256, 256, 256)):
        n = int(np.prod(shape))
        f = torch.rand(n + 1, device=dev)[1:].view(*shape, 1)
        v = (torch.randn(2 * n + 2, device=dev)[2:] * 2).view(*shape, 2)
        assert _gap(twk.advect_2d_kernel(f, v, -1.0),
                    twk.advect_2d_clamped_ref(f, v, -1.0)) <= 1e-5
        assert _gap(twk.align_triplet_kernel(f, f, f, v),
                    twk.align_triplet_ref(f, f, f, v)) <= 1e-5


@pytest.mark.cuda
def test_operator_refusals_and_counts():
    """Each refusal raises the wrapper's ValueError and counts no launch;
    the operator itself raises its refusal; a launch counts one."""
    dev = _card()
    p, c, n, v = _data(4, 16, 16, 1.5, dev)
    bad = [
        (lambda: twk.advect_2d_kernel(p.double(), v), "float32"),
        (lambda: twk.advect_2d_kernel(p, v.transpose(1, 2)), "contiguous"),
        (lambda: twk.advect_2d_kernel(p, v[..., :1]), r"\(B, H, W, 2\)"),
        (lambda: twk.align_triplet_kernel(p, c[:2], n, v), "must be"),
        (lambda: twk.align_triplet_kernel(p, c.cpu(), n, v), "float32"),
        (lambda: twk.align_triplet_kernel(p.cpu(), c.cpu(), n.cpu(),
                                          v.cpu()), "CUDA"),
    ]
    for fn, match in bad:
        before = twk.launches
        with pytest.raises(ValueError, match=match):
            fn()
        assert twk.launches == before
    with pytest.raises(RuntimeError, match=twk.REFUSED):
        torch.ops.mpgan_warp.warp2d_triplet(p, c, n, v.double(), R, 0, 0)
    before = twk.launches
    twk.align_triplet_kernel(p, c, n, v)
    twk.advect_2d_kernel(p, v, 1.0)
    torch.cuda.synchronize()
    assert twk.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 64, 64), (64, 256, 256)])
def test_graph_replay_equals_eager(shape):
    """One capture of each forward in a CUDA graph: the replay's outputs
    equal an eager call's bit for bit (one thread per pixel at the
    trainer's shape; tiles for one field at 64 x 256²)."""
    dev = _card()
    p, c, n, v = _data(*shape, 3.0, dev, seed=2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        twk.align_triplet_kernel(p, c, n, v)
        twk.advect_2d_kernel(p, v, -1.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out3 = twk.align_triplet_kernel(p, c, n, v)
        out1 = twk.advect_2d_kernel(p, v, -1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out3, twk.align_triplet_kernel(p, c, n, v))
    assert torch.equal(out1, twk.advect_2d_kernel(p, v, -1.0))
