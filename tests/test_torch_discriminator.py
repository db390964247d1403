"""The port's Ds/Dt vs flax apply with converted weights (CPU, float32,
TF32 off), and the pieces where a naive translation differs from flax:
``SAME`` padding of a strided conv, the NHWC flatten before the Dense head,
and the antialiased linear downsample.

Tolerances: logits atol 1e-4 (the convolutions in another summation order,
then a Dense over the whole flattened map); features atol 1e-5 (the
convolutions only); resize and conditioning atol 1e-6 (the same f32
arithmetic in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mpgan_torch import convert
from mpgan_torch.models import discriminator as TD
from mpgan_tpu.models import discriminator as JD

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

LOGIT_ATOL = 1e-4
FEAT_ATOL = 1e-5
RESIZE_ATOL = 1e-6
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _pair(kind, factors, stage, hw, c_in=5, base=8, seed=0):
    """(flax D, its params at ``stage``, the port's D with them)."""
    n = len(factors)
    if kind == "ds":
        jd = JD.make_spatial(n, base, factors=factors)
        td = TD.make_spatial(stage, c_in, hw, base, factors=factors)
    else:
        c_in = 3
        jd = JD.make_temporal(n, base, factors=factors)
        td = TD.make_temporal(stage, hw, base, factors=factors)
    params = jd.init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, c_in)),
                     stage=stage)
    td.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    return jd, params, td, c_in


CASES = [  # (kind, factors, stage, hw, fade, alpha)
    ("ds", ((2, 2), (2, 2)), 1, (8, 8), False, 1.0),
    ("ds", ((2, 2), (2, 2)), 2, (16, 16), False, 1.0),
    ("ds", ((2, 2), (2, 2)), 2, (16, 16), True, 0.0),
    ("ds", ((2, 2), (2, 2)), 2, (16, 16), True, 0.5),
    ("ds", ((2, 2), (2, 2)), 2, (16, 16), True, 1.0),
    ("ds", ((2, 1), (2, 1)), 1, (8, 16), False, 1.0),
    ("ds", ((2, 1), (2, 1)), 2, (16, 16), False, 1.0),
    ("ds", ((2, 1), (2, 1)), 2, (16, 16), True, 0.0),
    ("ds", ((2, 1), (2, 1)), 2, (16, 16), True, 0.5),
    ("ds", ((2, 1), (2, 1)), 2, (16, 16), True, 1.0),
    ("ds", ((2, 2), (2, 2)), 2, (10, 14), True, 0.5),   # odd after stride 2
    ("dt", ((2, 2), (2, 2)), 2, (16, 16), False, 1.0),
    ("dt", ((2, 2), (2, 2)), 2, (16, 16), True, 0.5),
    ("dt", ((2, 1), (2, 1)), 1, (8, 16), False, 1.0),
]


@pytest.mark.parametrize("kind,factors,stage,hw,fade,alpha", CASES)
def test_discriminator_matches_flax(kind, factors, stage, hw, fade, alpha):
    jd, params, td, c_in = _pair(kind, factors, stage, hw)
    x = np.random.default_rng(1).standard_normal(
        (3, *hw, c_in)).astype(np.float32)
    jl, jf = jd.apply(params, jnp.asarray(x), stage=stage, alpha=alpha,
                      fade=fade, return_features=True)
    with torch.no_grad():
        tl, tf = td(torch.from_numpy(x), alpha=alpha, fade=fade,
                    return_features=True)
    assert tl.shape == (3, 1) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)
    assert len(tf) == len(jf) == 2 * stage
    for a, b in zip(tf, jf):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=FEAT_ATOL)
    with torch.no_grad():
        plain = td(torch.from_numpy(x), alpha=alpha, fade=fade)
    torch.testing.assert_close(plain, tl, rtol=0, atol=0)


def test_strided_same_padding_is_asymmetric_on_even_sizes():
    """flax SAME with stride 2 on an even size pads 0 before and 1 after;
    a symmetric ``padding=1`` conv reads another window."""
    assert TD._same_pads(16, 2) == (0, 1)
    assert TD._same_pads(15, 2) == (1, 1)
    assert TD._same_pads(16, 1) == (1, 1)
    _, params, td, _ = _pair("ds", ((2, 2),), 1, (8, 8))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 8, 8, 5)).astype(np.float32))
    conv = td.down_0
    with torch.no_grad():
        h = TD._conv(td.from_in_0, x.permute(0, 3, 1, 2))
        same = TD._conv(conv, h, (2, 2))
        sym = F.conv2d(h, conv.weight, conv.bias, stride=2, padding=1)
    assert same.shape == sym.shape
    assert float((same - sym).abs().max()) > 1e-3


def test_dense_head_reads_the_nhwc_flatten():
    """out/kernel (in, 1) becomes out.weight (1, in), and the head's input
    is the last map flattened as (H, W, C)."""
    _, params, td, _ = _pair("ds", ((2, 2), (2, 2)), 2, (16, 16))
    kern = np.asarray(params["params"]["out"]["kernel"])
    assert kern.shape == (4 * 4 * 8, 1)
    np.testing.assert_array_equal(td.out.weight.detach().numpy(), kern.T)


@pytest.mark.parametrize("fh,fw", [(2, 2), (2, 1), (4, 4)])
def test_downsample_is_antialiased_resize(fh, fw):
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 3)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 16 // fh, 16 // fw, 3),
                            method="linear")
    got = TD.downsample_nhwc(torch.from_numpy(x), fh, fw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RESIZE_ATOL)


@pytest.mark.parametrize("fh,fw", [(2, 2), (2, 1)])
def test_downsample_gradient_is_its_adjoint(fh, fw):
    """The downsample's own backward (the fixed-order adjoint) against
    JAX's VJP of the resize and F.interpolate's autograd, and
    differentiable once more, as R1's double backward needs."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    g = rng.standard_normal((2, 16 // fh, 16 // fw, 3)).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, g.shape, "linear"),
                     jnp.asarray(x))
    want, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got, = torch.autograd.grad(TD.downsample_nhwc(xt, fh, fw), xt,
                               torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RESIZE_ATOL)
    x64 = torch.from_numpy(x).double().permute(0, 3, 1, 2).requires_grad_()
    g64 = torch.from_numpy(g).double().permute(0, 3, 1, 2)
    ref, = torch.autograd.grad(F.interpolate(
        x64, size=(16 // fh, 16 // fw), mode="bilinear",
        align_corners=False, antialias=True), x64, g64)
    got64, = torch.autograd.grad(TD.downsample(x64, fh, fw), x64, g64)
    torch.testing.assert_close(got64, ref, rtol=0, atol=1e-12)
    assert torch.autograd.gradgradcheck(
        lambda a: TD.downsample(a, fh, fw), (x64[:1, :1].detach()
                                             .requires_grad_(),))


@pytest.mark.parametrize("fh,fw", [(2, 2), (4, 4), (4, 1)])
def test_condition_ds_input_matches_jax(fh, fw):
    rng = np.random.default_rng(3)
    lr = rng.standard_normal((2, 4, 8, 4)).astype(np.float32)
    hr = rng.standard_normal((2, 4 * fh, 8 * fw, 1)).astype(np.float32)
    want = JD.condition_ds_input(jnp.asarray(lr), jnp.asarray(hr), fh, fw)
    got = TD.condition_ds_input(torch.from_numpy(lr), torch.from_numpy(hr),
                                fh, fw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=RESIZE_ATOL)


def test_bf16_discriminator_keeps_f32_params_and_outputs():
    _, _, td, _ = _pair("ds", ((2, 2), (2, 2)), 2, (16, 16))
    tb = TD.make_spatial(2, 5, (16, 16), 8, dtype=torch.bfloat16)
    tb.load_state_dict(td.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, 16, 5)).astype(np.float32))
    with torch.no_grad():
        lb, fb = tb(x, return_features=True)
        l32 = td(x)
    assert tb.out.weight.dtype == torch.float32
    assert lb.dtype == torch.float32 and fb[0].dtype == torch.float32
    assert float((lb - l32).abs().max()) < 0.1
