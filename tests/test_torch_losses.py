"""The port's GAN losses, R1 and WGAN-GP vs the JAX package (CPU,
float32), and the growing helpers vs ``mpgan_tpu/models/growing.py``.

Tolerances: rtol 1e-5 for loss values, R1 and GP (the same float32
arithmetic; GP's ε is drawn once by JAX and injected into the port);
rtol 1e-4 with atol 1e-7 for the penalties' gradients with respect to the
discriminator's parameters (a double backward through the convolutions,
summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import convert
from mpgan_torch.models import discriminator as TD
from mpgan_torch.models import growing as tgrow
from mpgan_torch.train import losses as tl
from mpgan_tpu.models import discriminator as JD
from mpgan_tpu.models import growing as jgrow
from mpgan_tpu.train import losses as jl

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

RTOL = 1e-5
torch.backends.cudnn.allow_tf32 = False


def _logits(seed, n=7):
    return np.random.default_rng(seed).standard_normal((n, 1)).astype(
        np.float32) * 2


@pytest.mark.parametrize("mode,smooth", [("sce", 0.0), ("sce", 0.1),
                                         ("lsgan", 0.0), ("lsgan", 0.2),
                                         ("hinge", 0.0), ("wgan", 0.0)])
def test_adversarial_losses_match_jax(mode, smooth):
    r, f = _logits(0), _logits(1)
    want = float(jl.d_loss(jnp.asarray(r), jnp.asarray(f), smooth, mode))
    got = float(tl.d_loss(torch.from_numpy(r), torch.from_numpy(f), smooth,
                          mode))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(
        float(tl.g_adv_loss(torch.from_numpy(f), mode)),
        float(jl.g_adv_loss(jnp.asarray(f), mode)), rtol=RTOL)


def test_bce_feature_l1_psnr_match_jax():
    rng = np.random.default_rng(2)
    x = _logits(3)
    np.testing.assert_allclose(float(tl.bce_logits(torch.from_numpy(x), 1.0)),
                               float(jl.bce_logits(jnp.asarray(x), 1.0)),
                               rtol=RTOL)
    fr = [rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
          for _ in range(3)]
    ff = [rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
          for _ in range(3)]
    np.testing.assert_allclose(
        float(tl.feature_loss([torch.from_numpy(a) for a in fr],
                              [torch.from_numpy(a) for a in ff])),
        float(jl.feature_loss([jnp.asarray(a) for a in fr],
                              [jnp.asarray(a) for a in ff])), rtol=RTOL)
    a, b = fr[0], ff[0]
    for t, j in ((tl.l1_loss, jl.l1_loss), (tl.psnr, jl.psnr)):
        np.testing.assert_allclose(
            float(t(torch.from_numpy(a), torch.from_numpy(b))),
            float(j(jnp.asarray(a), jnp.asarray(b))), rtol=RTOL)


def test_unknown_mode_raises():
    with pytest.raises(ValueError):
        tl.d_loss(torch.zeros(2, 1), torch.zeros(2, 1), 0.0, "bogus")
    with pytest.raises(ValueError):
        tl.g_adv_loss(torch.zeros(2, 1), "bogus")


def _disc_pair():
    jd = JD.make_spatial(1, 8)
    params = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 5)), stage=1)
    td = TD.make_spatial(1, 5, (8, 8), 8)
    td.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, params)))
    return jd, params, td


def _grads_close(td, jgrads):
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    for name, p in td.named_parameters():
        # a parameter the penalty does not reach (the head's bias) has no
        # gradient in torch and a zero one in JAX
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=name)


def test_r1_penalty_and_its_gradient_match_jax():
    jd, params, td = _disc_pair()
    real = np.random.default_rng(4).standard_normal((3, 8, 8, 5)).astype(
        np.float32)

    def jr1(p):
        return jl.r1_penalty(lambda x: jd.apply(p, x), jnp.asarray(real))

    want, jgrads = jax.value_and_grad(jr1)(params)
    got = tl.r1_penalty(td, torch.from_numpy(real))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    got.backward()
    _grads_close(td, jgrads)


def test_gradient_penalty_with_injected_eps_matches_jax():
    jd, params, td = _disc_pair()
    rng = np.random.default_rng(5)
    real = rng.standard_normal((3, 8, 8, 5)).astype(np.float32)
    fake = rng.standard_normal((3, 8, 8, 5)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    eps = np.array(jax.random.uniform(key, (3, 1, 1, 1)))

    def jgp(p):
        return jl.gradient_penalty(lambda x: jd.apply(p, x), jnp.asarray(real),
                                   jnp.asarray(fake), key)

    want, jgrads = jax.value_and_grad(jgp)(params)
    got = tl.gradient_penalty(td, torch.from_numpy(real),
                              torch.from_numpy(fake), torch.from_numpy(eps))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    got.backward()
    _grads_close(td, jgrads)


# --------------------------------------------------------------- growing

def test_migrate_params_is_a_strict_merge():
    old = {"a.weight": torch.ones(2, 3), "b.bias": torch.full((4,), 2.0)}
    new = {"a.weight": torch.zeros(2, 3), "b.bias": torch.zeros(4),
           "c.weight": torch.zeros(5)}
    out = tgrow.migrate_params(old, new)
    assert set(out) == set(new)
    assert torch.equal(out["a.weight"], old["a.weight"])
    assert torch.equal(out["c.weight"], new["c.weight"])
    with pytest.raises(KeyError):
        tgrow.migrate_params({"x.weight": torch.zeros(1)}, new)
    with pytest.raises(ValueError):
        tgrow.migrate_params({"a.weight": torch.zeros(3, 2)}, new)
    assert tgrow.subtree_check(old, new) and not tgrow.subtree_check(new, old)


@pytest.mark.parametrize("n,fade,stable", [(2, 3, 2), (3, 2, 0), (2, 0, 0),
                                           (1, 4, 4)])
def test_growth_schedule_matches_jax(n, fade, stable):
    ts, js = tgrow.GrowthSchedule(n, fade, stable), \
        jgrow.GrowthSchedule(n, fade, stable)
    assert ts.boundaries() == js.boundaries()
    for it in range(3 * (fade + stable) + 3):
        assert ts.stage_at(it) == js.stage_at(it), it
    for it, start in ((0, 0), (3, 1), (9, 4)):
        assert tgrow.alpha_schedule(it, start, fade) == \
            jgrow.alpha_schedule(it, start, fade)


def test_count_params_matches_flax():
    jd = JD.make_temporal(2, 8)
    params = jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                     stage=2)
    td = TD.make_temporal(2, (16, 16), 8)
    assert tgrow.count_params(td) == jgrow.count_params(params)
    assert tgrow.count_params(td.state_dict()) == tgrow.count_params(td)
