"""The port's generator vs flax apply, with flax-initialised parameters
converted by mpgan_torch.convert (CPU, float32, TF32 off).

Tolerance: atol 1e-5 — the same convolutions, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import convert
from mpgan_torch.models import generator as TG
from mpgan_tpu.models import generator as JG

ATOL = 1e-5
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _pair(pass_no, base=8, blocks=1, stages=2, c_in=4, hw=(6, 6), seed=0,
          **kw):
    """(flax gen, flax params, torch gen with the converted params)."""
    if pass_no == 1:
        jg = JG.make_pass1(stages, base, blocks)
        tg = TG.make_pass1(stages, base, blocks, in_channels=c_in, **kw)
    elif pass_no == 2:
        jg = JG.make_pass2(stages, base, blocks)
        tg = TG.make_pass2(stages, base, blocks, in_channels=c_in, **kw)
    else:
        jg = JG.make_pass3(base, blocks)
        tg = TG.make_pass3(base, blocks, in_channels=c_in, **kw)
    params = jg.init(jax.random.PRNGKey(seed), jnp.zeros((1, *hw, c_in)))
    sd = convert.flax_to_state_dict(jax.tree.map(np.asarray, params))
    tg.load_state_dict(sd, strict=True)
    return jg, params, tg.eval()


def _input(n=3, hw=(6, 6), c=4, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, *hw, c)).astype(np.float32)


CASES = [  # (pass, stage, fade, alpha)
    (1, 1, False, 1.0), (1, 2, False, 1.0), (1, 2, True, 0.0),
    (1, 2, True, 0.3), (1, 2, True, 1.0),
    (2, 1, False, 1.0), (2, 2, False, 1.0), (2, 2, True, 0.0),
    (2, 2, True, 0.3), (2, 2, True, 1.0),
    (3, None, False, 1.0),
]


@pytest.mark.parametrize("pass_no,stage,fade,alpha", CASES)
def test_generator_matches_flax(pass_no, stage, fade, alpha):
    jg, params, tg = _pair(pass_no)
    x = _input()
    want = np.asarray(jg.apply(params, jnp.asarray(x), stage=stage,
                               alpha=alpha, fade=fade))
    with torch.no_grad():
        got = tg(torch.from_numpy(x), stage=stage, alpha=alpha,
                 fade=fade).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("pass_no", [1, 2, 3])
def test_state_dict_keys_map_one_to_one(pass_no):
    """Every flax leaf lands on exactly one torch parameter of the same
    size, with ``proj`` present only where the width changes."""
    jg, params, tg = _pair(pass_no, base=16, blocks=2)
    flat = convert.flatten_params(jax.tree.map(np.asarray, params))
    sd = convert.flax_to_state_dict(flat)
    mine = tg.state_dict()
    assert set(sd) == set(mine)
    assert len(sd) == len(flat)
    for k, v in sd.items():
        assert v.shape == mine[k].shape, k
    assert "block_0_0.proj.weight" in mine
    assert not any(k.startswith("block_0_1.proj") for k in mine)
    x = _input(hw=(6, 6))
    want = np.asarray(jg.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_seven_channel_stem_matches_flax():
    """Pass 1 with vorticity input: a 7-channel stem."""
    jg, params, tg = _pair(1, c_in=7)
    x = _input(c=7)
    want = np.asarray(jg.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_bf16_compute_returns_out_dtype():
    """bf16 compute with f32 params: bf16 out when asked, f32 by default,
    close to the f32 model."""
    _, params, t32 = _pair(1)
    sd = t32.state_dict()
    tb = TG.make_pass1(2, 8, 1, dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    tb.load_state_dict(sd)
    tb_f32out = TG.make_pass1(2, 8, 1, dtype=torch.bfloat16)
    tb_f32out.load_state_dict(sd)
    assert tb.stem.weight.dtype == torch.float32
    x = torch.from_numpy(_input())
    with torch.no_grad():
        ob, of, o32 = tb(x), tb_f32out(x), t32(x)
    assert ob.dtype == torch.bfloat16 and of.dtype == torch.float32
    assert torch.equal(ob.float(), of)
    assert float((ob.float() - o32).abs().max()) < 0.1


def test_remat_matches_plain_with_grads():
    _, _, tg = _pair(1)
    tr = TG.make_pass1(2, 8, 1, remat=True)
    tr.load_state_dict(tg.state_dict())
    x = torch.from_numpy(_input())
    out_p, out_r = tg(x), tr(x)
    torch.testing.assert_close(out_r, out_p, rtol=0, atol=0)
    out_p.square().sum().backward()
    out_r.square().sum().backward()
    for (n, a), (_, b) in zip(tg.named_parameters(), tr.named_parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=0, atol=1e-6,
                                   msg=n)


def test_stage_out_of_range_raises():
    _, _, tg = _pair(1)
    with pytest.raises(ValueError):
        tg(torch.zeros(1, 6, 6, 4), stage=3)
