"""Fresh models of the port are initialised as flax initialises them:
lecun-normal kernels (a normal cut at ±2σ whose variance after the cut is
1/fan_in) and zero biases — for G, Ds and Dt at the flagship widths, with
flax's own models at the same shapes as the yardstick.

Tolerance on each kernel's std: 5% of 1/√fan_in, widened to four standard
errors of a sample std (4/√(2n)) for kernels of n < 3200 values, where 5%
is under 4 standard errors; the flax kernels meet the same bound. Values
may not pass the cut, 2/(√fan_in·0.8796).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch.models import discriminator as TD
from mpgan_torch.models import generator as TG
from mpgan_torch.models import init
from mpgan_tpu.models import discriminator as JD
from mpgan_tpu.models import generator as JG

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)


def _models(kind):
    """(port model, flax params) at the flagship widths: G base 32 with 2
    res blocks, D base 32 on 64² inputs, 4× (2 stages)."""
    g = torch.Generator().manual_seed(3)
    if kind == "g":
        tm = TG.make_pass1(2, 32, 2, in_channels=4, generator=g)
        jm, x = JG.make_pass1(2, 32, 2), jnp.zeros((1, 16, 16, 4))
    elif kind == "ds":
        tm = TD.make_spatial(2, 5, (64, 64), 32, generator=g)
        jm, x = JD.make_spatial(2, 32), jnp.zeros((1, 64, 64, 5))
    else:
        tm = TD.make_temporal(2, (64, 64), 32, generator=g)
        jm, x = JD.make_temporal(2, 32), jnp.zeros((1, 64, 64, 3))
    return tm, jax.jit(jm.init)(jax.random.PRNGKey(3), x)


def _check_kernel(w: np.ndarray, fan_in: int, what: str):
    n = w.size
    std = 1.0 / math.sqrt(fan_in)
    tol = max(0.05, 4.0 / math.sqrt(2 * n))
    assert abs(w.std() / std - 1.0) <= tol, (what, w.std() / std, tol)
    assert np.abs(w).max() <= 2.0 * std / init.TRUNC_STD * (1 + 1e-6), what
    assert abs(w.mean()) <= 4.0 * std / math.sqrt(n), what
    return w.std() * math.sqrt(fan_in)


@pytest.mark.parametrize("kind", ["g", "ds", "dt"])
def test_fresh_models_are_initialised_as_flax(kind):
    tm, jp = _models(kind)
    ratios_t, ratios_j = [], []
    for name, p in tm.named_parameters():
        w = p.detach().numpy()
        if name.endswith("bias"):
            assert not w.any(), name
            continue
        fan_in = int(np.prod(p.shape[1:]))
        ratios_t.append(_check_kernel(w, fan_in, name))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        w = np.asarray(leaf)
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']"):
            assert not w.any(), name
            continue
        fan_in = int(np.prod(w.shape[:-1]))
        ratios_j.append(_check_kernel(w, fan_in, name))
    assert len(ratios_t) == len(ratios_j)
    # pooled over the model, both sit at the same variance
    assert abs(np.mean(ratios_t) - np.mean(ratios_j)) < 0.03


def test_init_draws_only_from_the_given_generator():
    """Two models from equal seeds are equal; the global generator is not
    touched."""
    state = torch.random.get_rng_state()
    a = TG.make_pass1(2, 8, 1, generator=torch.Generator().manual_seed(5))
    b = TG.make_pass1(2, 8, 1, generator=torch.Generator().manual_seed(5))
    c = TG.make_pass1(2, 8, 1, generator=torch.Generator().manual_seed(6))
    assert torch.equal(torch.random.get_rng_state(), state)
    for (n, p), (_, q), (_, r) in zip(a.named_parameters(),
                                      b.named_parameters(),
                                      c.named_parameters()):
        assert torch.equal(p, q), n
        if n.endswith("weight"):
            assert not torch.equal(p, r), n
