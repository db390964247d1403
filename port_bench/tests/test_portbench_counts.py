"""The FLOP and byte counts against hand counts and against the convolutions
the reference actually runs, and the configurations against the bundled
generators' shapes."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from port_bench import counts
from port_bench.drivers import common, train
from port_bench.reference import nets
from port_bench.tests import tiny

SMALL_G = {"in_channels": 2, "factors": [(2, 2)], "base_filters": 4,
           "min_filters": 2, "n_res_blocks": 1, "out_channels": 1}


def test_generator_flops_by_hand():
    # stem 2→4 at 3×5; stage 0 at 6×10: conv1 4→2, conv2 2→2, proj 4→2
    # (1×1), head 2→1
    hand = (2 * 9 * 2 * 4 * 15
            + (2 * 9 * 4 * 2 + 2 * 9 * 2 * 2 + 2 * 4 * 2 + 2 * 9 * 2) * 60)
    assert counts.generator_flops(SMALL_G, 3, 5) == hand


def _counted(fn):
    """The convolution and dense FLOPs ``fn`` runs through the reference
    (2·k²·Cin per output element)."""
    total = [0]
    real_conv, real_linear = F.conv2d, F.linear

    def conv(x, w, b=None, **kw):
        y = real_conv(x, w, b, **kw)
        total[0] += 2 * w.shape[1] * w.shape[2] * w.shape[3] * y.numel()
        return y

    def linear(x, w, b=None):
        y = real_linear(x, w, b)
        total[0] += 2 * w.shape[1] * y.numel()
        return y
    nets.F.conv2d, nets.F.linear = conv, linear
    try:
        fn()
    finally:
        nets.F.conv2d, nets.F.linear = real_conv, real_linear
    return total[0]


@pytest.mark.parametrize("factors", [[(2, 2), (2, 2)], [(2, 1), (2, 1)],
                                     [(2, 2)] * 3])
def test_generator_flops_are_the_reference_convolutions(factors):
    g = {**SMALL_G, "factors": factors, "base_filters": 8, "min_filters": 2,
         "n_res_blocks": 2, "in_channels": 4}
    gen = torch.Generator().manual_seed(0)
    p = nets.make_weights(nets.generator_layout(g), gen, "cpu")
    x = torch.rand(3, 5, 7, 4)
    n = _counted(lambda: nets.generator(p, g, x))
    assert n == 3 * counts.generator_flops(g, 5, 7)


@pytest.mark.parametrize("c_in", [5, 3])
def test_discriminator_flops_are_the_reference_convolutions(c_in):
    d = {"in_channels": c_in, "in_hw": [16, 16], "factors": [(2, 2), (2, 2)],
         "base_filters": 8, "min_filters": 2, "max_filters": 256}
    gen = torch.Generator().manual_seed(0)
    p = nets.make_weights(nets.discriminator_layout(d), gen, "cpu")
    x = torch.rand(2, 16, 16, c_in)
    n = _counted(lambda: nets.discriminator(p, d, x))
    assert n == 2 * counts.discriminator_flops(d)


def test_frame_flops_of_the_4x_frame():
    cfg = tiny.load("configs", "mpgan-4x")
    d1 = common.generator_desc(cfg["generator_pass1"])
    d2 = common.generator_desc(cfg["generator_pass2"])
    per_slice1 = counts.generator_flops(d1, 64, 64)
    per_slice2 = counts.generator_flops(d2, 64, 256)
    assert counts.frame_flops(d1, d2, (64, 64, 64), 4) == \
        64 * per_slice1 + 256 * per_slice2
    # stem 9.44 M, stage 0 399 M, stage 1 404 M a 64² slice
    assert per_slice1 == 2 * 9 * 4 * 32 * 4096 + 24352 * 16384 + 6160 * 65536


def test_train_step_flops_count_each_pass():
    cfg = train.descriptions(tiny.load("configs", "mpgan-4x"))
    gf = counts.generator_flops(cfg["generator"], 16, 16)
    dsf = counts.discriminator_flops(cfg["spatial_disc"])
    dtf = counts.discriminator_flops(cfg["temporal_disc"])
    b = 16
    want = (48 * gf + 96 * dsf + 96 * dtf            # D-run
            + 144 * gf + 64 * dsf + 48 * dtf         # G-run
            + 9 * b * (dsf + dtf) / 16)              # lazy R1
    assert counts.train_step_flops(cfg) == pytest.approx(want)


def test_warp_bytes_by_hand():
    px = 16 * 64 * 64
    assert counts.warp_bytes(16, 64, 64, False) == 32 * px
    assert counts.warp_bytes(16, 64, 64, True) == 24 * px
    assert counts.warp_bytes(16, 64, 64, True, vel_grad=True) == 40 * px
    cfg = train.descriptions(tiny.load("configs", "mpgan-4x"))
    assert counts.train_warp_bytes(cfg) == 3 * 32 * px + 24 * px
    # the least times of the kernel table: 0.626 and 0.470 µs
    assert 32 * px / 3.35e12 == pytest.approx(0.626e-6, abs=5e-10)
    assert 24 * px / 3.35e12 == pytest.approx(0.470e-6, abs=5e-10)


@pytest.mark.parametrize("name,bundle", [
    ("mpgan-4x", "4x"), ("mpgan-8x", "8x")])
def test_configurations_have_the_bundled_generators_shapes(name, bundle):
    from mpgan_torch import convert
    cfg = tiny.load("configs", name)
    root = os.path.dirname(tiny.BENCH)
    for pass_no in (1, 2):
        path = os.path.join(root, "mpgan_torch", "weights",
                            f"g{pass_no}_l1_{bundle}.npz")
        flat, _ = convert.load_npz(path)
        sd = convert.flax_to_state_dict(flat)
        layout = nets.generator_layout(
            common.generator_desc(cfg[f"generator_pass{pass_no}"]))
        assert {k: tuple(np.shape(v)) for k, v in sd.items()} == \
            dict(layout)


def test_peaks_are_the_published_ones():
    with open(counts.PEAKS) as fh:
        peaks = json.load(fh)
    assert peaks["bf16_dense_flops_per_s"] == 989e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
