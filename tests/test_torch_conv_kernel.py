"""The generator's NHWC convolutions (``mpgan_torch.ops.conv_kernel``,
``csrc/conv.cu``) and the path rule of ``Generator.forward``.

On the CPU: each plain fused op against the NCHW composition the cuDNN
forward runs (``F.conv2d`` + bias + ReLU + sum) at every width the
kernels take, within 1e-5 in float32; the same with slice views strided
as passes 2 and 3 hand them over, read in place; the NHWC forward through
the plain versions against ``Generator.forward``'s cuDNN path for passes
1 and 2 at stages 1 and 2 and for pass 3, within 1e-5 in float32 and, in
bf16, within 2^-6 of the output's largest magnitude (the NHWC forward
rounds once per convolution where the cuDNN path rounds after the
convolution, the bias and the sum: about two bf16 ulps of the output
apart); and each condition of the path rule.

On a card (marked ``cuda``; every test skips without one, decided inside
the test): each kernel against its plain version at the main path's
shapes and at ragged ones, within one bf16 ulp of the value plus 1e-4 of
the output's largest magnitude (both sum in float32 in another order and
round once); two calls bit for bit; a captured replay against the eager
call; the generator under ``inference_mode`` against its cuDNN forward
under ``no_grad``; a traced 4x frame without cuDNN's kernels; a graphed
train step that keeps them; the bundled 4x chain's PSNR on both paths.
Imports no JAX, so the card's machine runs it alone:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_conv_kernel.py -m cuda
"""

import copy
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpgan_torch.models import generator as G
from mpgan_torch.models import init
from mpgan_torch.ops import conv_kernel as ck
from mpgan_torch.ops.upsample import upsample_nchw

torch.set_num_threads(1)

BF16_REL = 2.0 ** -6


def _conv(cin, cout, k, seed):
    gen = torch.Generator().manual_seed(seed)
    conv = init.conv2d(cin, cout, k, gen, padding=k // 2)
    with torch.no_grad():
        conv.bias.normal_(0.0, 0.1, generator=gen)
    return conv


def _x(shape, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device, dtype)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(y):
    return y.permute(0, 2, 3, 1)


def _gap(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


# ------------------------------------------------------------ CPU: plain ops


@pytest.mark.parametrize("cin,cout", sorted(ck.RELU))
def test_relu_plain_matches_nchw_composition(cin, cout):
    conv = _conv(cin, cout, 3, cin + cout)
    x = _x((2, 9, 11, cin), cin)
    want = _nhwc(F.relu(G._conv(conv, _nchw(x))))
    assert _gap(ck.conv_relu(x, conv), want) <= 1e-5


@pytest.mark.parametrize("c,cx", sorted(ck.RESIDUAL))
def test_residual_plain_matches_resblock(c, cx):
    gen = torch.Generator().manual_seed(c * 100 + cx)
    block = G.ResBlock(cx, c, gen)
    x = _x((2, 9, 11, cx), c + cx)
    h = ck.conv_relu(x, block.conv1)
    got = ck.conv_residual(h, block.conv2, x, block.proj)
    assert (block.proj is None) == (c == cx)
    assert _gap(got, _nhwc(block(_nchw(x)))) <= 1e-5


@pytest.mark.parametrize("cin", sorted(ck.HEAD))
@pytest.mark.parametrize("factors", [(1, 1), (2, 1), (2, 2), (4, 4)])
def test_head_plain_matches_conv_and_skip(cin, factors):
    head = _conv(cin, 1, 3, cin)
    h = _x((2, 8, 8, cin), cin)
    dens = _x((2, 8 // factors[0], 8 // factors[1], 1), 7)
    want = G._conv(head, _nchw(h)) + upsample_nchw(_nchw(dens), *factors)
    got = ck.conv_head(h, head, dens, factors)
    assert got.shape == (2, 8, 8, 1) and got.dtype == torch.float32
    assert _gap(got, _nhwc(want)) <= 1e-5
    assert _gap(ck.conv_head(h, head), _nhwc(G._conv(head, _nchw(h)))) <= 1e-5


def test_plain_ops_round_once_in_bf16():
    """In bf16 the plain op rounds the parameters and the result, and sums
    in float32: equal to the float32 op on the rounded operands, rounded."""
    conv = _conv(16, 8, 3, 3)
    x = _x((2, 6, 7, 16), 3, torch.bfloat16)
    got = ck.conv_relu(x, conv)
    assert got.dtype == torch.bfloat16
    w, b = conv.weight.to(torch.bfloat16).float(), conv.bias.to(
        torch.bfloat16).float()
    want = F.relu(F.conv2d(_nchw(x.float()), w, b, padding=1))
    assert torch.equal(got, _nhwc(want).to(torch.bfloat16))


def _volume(z, y, x, c, seed):
    return _x((z, y, x, c), seed)


@pytest.mark.parametrize("view", ["pass2", "pass3"])
def test_strided_slice_views_are_read_in_place(view):
    """A pass's slice view of its (Z, Y, X, C) volume: the kernel reads it
    at its strides (no copy), and the plain ops give the contiguous
    slices' results; the head's density skip reads channel 0 in place."""
    vol = _volume(6, 8, 16, 4, 1).to(torch.bfloat16)
    slices = (vol.permute(1, 0, 2, 3) if view == "pass2"
              else vol.permute(2, 1, 0, 3))
    assert not slices.is_contiguous()
    assert ck._readable(slices) is slices
    stem, head = _conv(4, 16, 3, 5), _conv(16, 1, 3, 6)
    dense = slices.contiguous()
    h = ck.conv_relu(slices, stem)
    assert torch.equal(h, ck.conv_relu(dense, stem))
    assert torch.equal(ck.conv_head(h, head, slices[..., 0:1]),
                       ck.conv_head(h, head, dense[..., 0:1]))
    # a view the copies cannot read in place is copied first
    odd = torch.zeros((3, 5, 5, 9), dtype=torch.bfloat16)[..., 1:5]
    assert ck._readable(odd) is not odd and ck._readable(odd).is_contiguous()


# ------------------------------------------------ CPU: the generator's paths


def _gen(pass_no, dtype, seed=0, base_filters=16):
    gen = torch.Generator().manual_seed(seed)
    kw = dict(dtype=dtype, out_dtype=dtype, generator=gen,
              base_filters=base_filters)
    g = (G.make_pass1(2, **kw) if pass_no == 1 else G.make_pass2(2, **kw)
         if pass_no == 2 else G.make_pass3(**kw))
    with torch.no_grad():
        for p in g.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return g


CHAIN_CASES = [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1)]


@pytest.mark.parametrize("pass_no,stage", CHAIN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nhwc_forward_matches_cudnn_forward(pass_no, stage, dtype):
    dt = getattr(torch, dtype)
    g = _gen(pass_no, dt, seed=pass_no * 10 + stage)
    assert g.nhwc_widths
    x = _x((3, 8, 8, 4), pass_no).abs()
    if pass_no == 3:
        # pass 3's yz slices of an xyz volume
        x = _volume(8, 8, 3, 4, 5).abs().permute(2, 1, 0, 3)
    with torch.no_grad():
        want = g(x, stage=stage).float()
        got = g.forward_nhwc(x, stage).float()
    assert got.shape == want.shape
    tol = 1e-5 if dt == torch.float32 else BF16_REL * float(want.abs().max())
    assert _gap(got, want) <= tol


def _card_like():
    """A stand-in input that reports a card: the rule reads ``is_cuda``."""
    return types.SimpleNamespace(is_cuda=True)


def test_path_rule_takes_all_four_conditions(monkeypatch):
    """``Generator.forward`` runs the NHWC forward only for a CUDA input,
    bf16 compute, inference mode, no fade-in and widths the kernels take;
    any one missing keeps the cuDNN forward."""
    g16 = _gen(1, torch.bfloat16)
    taken = []
    monkeypatch.setattr(G.Generator, "forward_nhwc",
                        lambda self, x, *a: taken.append(x) or "nhwc")
    card = _card_like()
    n0 = (G.nhwc_forwards, G.cudnn_forwards)
    with torch.inference_mode():
        assert g16.takes_nhwc(card)
        assert g16(card) == "nhwc"
    assert taken == [card]
    assert (G.nhwc_forwards - n0[0], G.cudnn_forwards - n0[1]) == (1, 0)
    x = _x((2, 8, 8, 4), 0)
    cases = {
        "cpu input": (g16, x, torch.inference_mode()),
        "float32": (_gen(1, torch.float32), card, torch.inference_mode()),
        "no_grad without inference mode": (g16, card, torch.no_grad()),
        "grad enabled": (g16, card, torch.enable_grad()),
        "fade-in": (g16, card, torch.inference_mode()),
        "7-channel stem": (G.make_pass1(2, dtype=torch.bfloat16,
                                        in_channels=7), card,
                           torch.inference_mode()),
        "64-wide stem": (G.make_pass1(2, dtype=torch.bfloat16,
                                      base_filters=64), card,
                         torch.inference_mode()),
    }
    for name, (g, inp, mode) in cases.items():
        with mode:
            assert not g.takes_nhwc(inp, fade=name == "fade-in"), name
            if inp is x:
                n0 = (G.nhwc_forwards, G.cudnn_forwards)
                out = g(inp)
                assert isinstance(out, torch.Tensor), name
                assert (G.nhwc_forwards - n0[0],
                        G.cudnn_forwards - n0[1]) == (0, 1), name
    assert taken == [card]
    assert not G.make_pass1(2, in_channels=7).nhwc_widths
    assert G.make_pass1(3, base_filters=32).nhwc_widths
    assert G.make_pass3(base_filters=32).nhwc_widths


def test_takes_reads_every_width():
    assert G.make_pass2(3).nhwc_widths
    assert not G.Generator(4, out_channels=2).nhwc_widths
    assert not G.Generator(4, base_filters=32, min_filters=4,
                           factors=((2, 2),) * 4).nhwc_widths


# ------------------------------------------------------------ on a card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the conv kernels have no CPU mode")
    return torch.device("cuda")


def _cpu(m):
    """A CPU copy of a module (``m.cpu()`` would move ``m`` itself)."""
    return None if m is None else copy.deepcopy(m).cpu()


def _close(got, want):
    """One bf16 ulp of each value plus 1e-4 of the largest magnitude."""
    g, w = got.float().cpu(), want.float().cpu()
    tol = 2.0 ** -7 * w.abs() + 1e-4 * float(w.abs().max())
    gap = (g - w).abs()
    assert bool((gap <= tol).all()), (float(gap.max()),
                                      float((gap - tol).max()))


# the main path's layers (4x and 8x G1/G2, G3) and ragged shapes
RELU_SHAPES = [((64, 64, 64), 4, 32), ((16, 128, 128), 32, 16),
               ((16, 128, 128), 16, 16), ((8, 256, 256), 16, 8),
               ((8, 256, 256), 8, 8)]
RES_SHAPES = [((16, 128, 128), 16, 32), ((16, 128, 128), 16, 16),
              ((8, 256, 256), 8, 16), ((8, 256, 256), 8, 8)]


@pytest.mark.cuda
def test_cuda_kernels_match_plain_at_the_main_path_shapes():
    dev = _card()
    for shape, cin, cout in RELU_SHAPES:
        conv = _conv(cin, cout, 3, cin).to(dev)
        x = _x((*shape, cin), cin, torch.bfloat16, dev)
        _close(ck.conv_relu(x, conv), ck.conv_relu_ref(x.cpu(), _cpu(conv)))
    for shape, c, cx in RES_SHAPES:
        block = G.ResBlock(cx, c, torch.Generator().manual_seed(c)).to(dev)
        x = _x((*shape, cx), cx, torch.bfloat16, dev).relu()
        h = _x((*shape, c), c, torch.bfloat16, dev).relu()
        got = ck.conv_residual(h, block.conv2, x, block.proj)
        want = ck.conv_residual_ref(h.cpu(), _cpu(block.conv2), x.cpu(),
                                    _cpu(block.proj))
        _close(got, want)
    for cin, factors in ((16, (2, 2)), (8, (4, 4)), (8, (2, 1)),
                         (16, (1, 1))):
        head = _conv(cin, 1, 3, cin).to(dev)
        h = _x((8, 256, 256, cin), cin, torch.bfloat16, dev)
        dens = _x((8, 256 // factors[0], 256 // factors[1], 1), 1,
                  torch.bfloat16, dev)
        for out_dtype in (torch.float32, torch.bfloat16):
            got = ck.conv_head(h, head, dens, factors, out_dtype)
            assert got.dtype == out_dtype
            _close(got, ck.conv_head_ref(h.cpu(), _cpu(head), dens.cpu(),
                                         factors, out_dtype))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_at_every_width_and_ragged_shapes():
    dev = _card()
    shape = (3, 37, 45)
    for cin, cout in sorted(ck.RELU):
        conv = _conv(cin, cout, 3, cin * cout).to(dev)
        x = _x((*shape, cin), cin, torch.bfloat16, dev)
        _close(ck.conv_relu(x, conv), ck.conv_relu_ref(x.cpu(), _cpu(conv)))
    for c, cx in sorted(ck.RESIDUAL):
        block = G.ResBlock(cx, c, torch.Generator().manual_seed(c + cx))
        block = block.to(dev)
        x = _x((*shape, cx), cx, torch.bfloat16, dev)
        h = _x((*shape, c), c + 1, torch.bfloat16, dev)
        proj = block.proj
        _close(ck.conv_residual(h, block.conv2, x, proj),
               ck.conv_residual_ref(h.cpu(), _cpu(block.conv2), x.cpu(),
                                    _cpu(proj)))
    for cin in sorted(ck.HEAD):
        head = _conv(cin, 1, 3, cin).to(dev)
        h = _x((3, 38, 46, cin), cin, torch.bfloat16, dev)
        dens = _x((3, 19, 23, 1), 2, torch.bfloat16, dev)
        _close(ck.conv_head(h, head, dens, (2, 2)),
               ck.conv_head_ref(h.cpu(), _cpu(head), dens.cpu(), (2, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["pass2", "pass3"])
def test_cuda_strided_views_read_in_place(view):
    dev = _card()
    vol = _x((64, 128, 128, 4), 3, torch.bfloat16, dev)
    slices = (vol.permute(1, 0, 2, 3) if view == "pass2"
              else vol.permute(2, 1, 0, 3))
    stem, head = _conv(4, 32, 3, 1).to(dev), _conv(32, 1, 3, 2).to(dev)
    h = ck.conv_relu(slices, stem)
    assert torch.equal(h, ck.conv_relu(slices.contiguous(), stem))
    _close(h, ck.conv_relu_ref(slices.cpu(), _cpu(stem)))
    got = ck.conv_head(h, head, slices[..., 0:1], (1, 1), torch.bfloat16)
    assert torch.equal(got, ck.conv_head(h, head, slices.contiguous()[
        ..., 0:1], (1, 1), torch.bfloat16))


@pytest.mark.cuda
def test_cuda_two_runs_bit_for_bit_and_the_launch_count():
    dev = _card()
    g = _gen(1, torch.bfloat16).to(dev)
    x = _x((16, 64, 64, 4), 1, torch.bfloat16, dev).abs()
    n0 = ck.launches
    with torch.inference_mode():
        a = g(x)
        b = g(x)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    # stem, 2 stages x 2 blocks x 2, one head; per call
    assert ck.launches - n0 == 2 * (1 + 2 * 2 * 2 + 1)


@pytest.mark.cuda
def test_cuda_captured_replay_equals_eager():
    from mpgan_torch.train import graphed
    dev = _card()
    g = _gen(2, torch.bfloat16).to(dev)
    x = _x((16, 32, 64, 4), 2, torch.bfloat16, dev).abs()
    with torch.inference_mode():
        eager = g(x)
        n0 = ck.launches
        graph = graphed.Graph(lambda: g(x), dev)
        assert ck.launches == n0 and graph.conv_launches == 10
        out = graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert ck.launches - n0 == 10
        # parameters changed in place are read by the next replay
        with torch.inference_mode(False), torch.no_grad():
            g.head_1.bias.add_(1.0)
        out = graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, g(x))
        graph.reset()


def _cudnn_and_nhwc(g, x):
    with torch.no_grad():
        ref = g(x)
    n0 = (G.nhwc_forwards, G.cudnn_forwards)
    with torch.inference_mode():
        got = g(x)
    assert (G.nhwc_forwards - n0[0], G.cudnn_forwards - n0[1]) == (1, 0)
    return got, ref


def _rel_rms(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("pass_no", [1, 2, 3])
def test_cuda_generator_inference_matches_cudnn_forward(pass_no):
    dev = _card()
    g = _gen(pass_no, torch.bfloat16, seed=pass_no, base_filters=32).to(dev)
    vol = _x((32, 64, 64, 4), pass_no, torch.bfloat16, dev).abs()
    x = vol.permute(2, 1, 0, 3) if pass_no == 3 else vol
    got, ref = _cudnn_and_nhwc(g, x)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert _rel_rms(got, ref) < 1e-2


NO_CUDNN = ("nchwToNhwc", "nhwcToNchw", "sm80_xmma_fprop")
# the kernels' names in a trace: (anonymous namespace)::conv_kernel<...>
OURS = "::conv_kernel<"


def _device_kernels(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
def test_cuda_traced_4x_frame_runs_no_cudnn_kernel():
    from mpgan_torch.infer import assemble
    dev = _card()
    kw = dict(dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    g1, g2 = G.make_pass1(2, **kw).to(dev), G.make_pass2(2, **kw).to(dev)
    up = assemble.make_graphed_upscaler(g1, g2, 4)
    lr = _x((64, 64, 64, 4), 0, torch.float32, dev).abs()
    for _ in range(3):
        up(lr)
    names = _device_kernels(lambda: up(lr))
    assert any(OURS in n for n in names), names
    assert not [n for n in names if any(k in n for k in NO_CUDNN)], names


@pytest.mark.cuda
def test_cuda_graphed_train_step_keeps_cudnn(monkeypatch):
    from mpgan_torch.data import pipeline as tpipeline
    from mpgan_torch.train import loop as tloop
    from mpgan_torch.train import recipe
    dev = _card()
    cfg = recipe.flagship_config("bfloat16", batch=2, tile=4)
    cfg.model.n_base_filters = 8
    cfg.model.n_res_blocks = 1
    cfg.model.disc_base_filters = 8
    ds = recipe.synthetic_dataset(size=8, up=4, seed=2)
    tc = tpipeline.TileCreator(ds, 4, density_threshold=0.0, device=dev)
    tr = tloop.Trainer(cfg, tc, device=dev, graphs=True)
    n0 = (G.nhwc_forwards, G.cudnn_forwards, ck.launches)
    # eager first uses and captures run the generator's forward in Python
    tr.fit(3, log_every=3)
    assert G.cudnn_forwards > n0[1]
    assert (G.nhwc_forwards, ck.launches) == (n0[0], n0[2])
    names = _device_kernels(lambda: tr.fit(2, log_every=2))
    assert (G.nhwc_forwards, ck.launches) == (n0[0], n0[2])
    assert not [n for n in names if OURS in n], names
    assert [n for n in names if any(k in n.lower() for k in (
        "xmma", "cudnn", "convolve", "fprop", "conv2d"))], names


@pytest.mark.cuda
def test_cuda_bundled_4x_chain_psnr_on_both_paths():
    from mpgan_torch.infer import assemble, load
    from mpgan_torch.quality import read_frame
    dev = _card()
    lr, gt = read_frame("sim_1010c", 12)
    lr = torch.from_numpy(lr).to(dev)
    g1 = load.load_bundled("g1_l1_4x", "bfloat16", dev)
    g2 = load.load_bundled("g2_l1_4x", "bfloat16", dev)
    assert g1.nhwc_widths and g2.nhwc_widths
    n0 = G.nhwc_forwards
    with torch.inference_mode():
        new = assemble.upscale_volume(g1, g2, lr, 4)
    assert G.nhwc_forwards - n0 == 2
    with torch.no_grad():
        old = assemble.upscale_volume(g1, g2, lr, 4)
    p_new = assemble.psnr_volume(new, gt)
    p_old = assemble.psnr_volume(old, gt)
    assert abs(p_new - p_old) <= 0.05, (p_new, p_old)
    assert p_new >= 34.5, p_new
