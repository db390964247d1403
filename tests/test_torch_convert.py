"""The port's generator saves in the flax weight format, both ways (CPU,
float32): ``state_dict_to_flax`` inverts ``flax_to_state_dict`` for G, Ds
and Dt bit for bit; a generator the port trained and saved as
``gen_%04d/params.npz`` equals the port's forward when flax applies it;
and JAX parameters written into a run dir load through the port's
``load_generator`` (``-1`` discovery, the mid-growth stage of the
``model_%04d.json`` sidecar, ``useEma`` and its fallback) and equal JAX's
``apply``.

Tolerance: bit-equal for the round trips, atol 1e-5 for the forwards (the
same convolutions, summed in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import config as tconfig
from mpgan_torch import convert
from mpgan_torch.data import pipeline as tpipeline
from mpgan_torch.infer import load as TL
from mpgan_torch.train import checkpoint as tckpt
from mpgan_torch.train import loop as tloop
from mpgan_torch.train import recipe
from mpgan_tpu.models import discriminator as JD
from mpgan_tpu.models import generator as JG

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-5


def _unflatten(flat: dict) -> dict:
    """Flat ``a/b/kernel`` params → the nested ``{"params": ...}`` tree."""
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        *mods, leaf = key.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(arr)
    return {"params": tree}


NETS = {  # name: (flax module, example input, init kwargs)
    "g_pass1": (JG.make_pass1(2, 8, 1), (1, 6, 6, 4), {}),
    "g_pass3": (JG.make_pass3(8, 1), (1, 16, 16, 4), {}),
    "ds": (JD.make_spatial(2, 8, factors=((2, 1), (2, 1))), (1, 16, 16, 5),
           {"stage": 2}),
    "dt": (JD.make_temporal(2, 8), (1, 16, 16, 3), {"stage": 2}),
    "ds_pass3": (JD.make_spatial(1, 8, factors=((1, 1),)), (1, 16, 16, 5),
                 {"stage": 1}),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_state_dict_to_flax_inverts_flax_to_state_dict(name):
    net, shape, kw = NETS[name]
    params = net.init(jax.random.PRNGKey(0), jnp.zeros(shape), **kw)
    flat = convert.flatten_params(jax.tree.map(np.asarray, params))
    back = convert.state_dict_to_flax(convert.flax_to_state_dict(flat))
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _small_cfg(**train_kw):
    cfg = recipe.flagship_config("float32", batch=2, tile=4)
    cfg.model.n_base_filters = 8
    cfg.model.n_res_blocks = 1
    cfg.model.disc_base_filters = 8
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


def test_port_trained_generator_applies_in_flax(tmp_path):
    """Two port steps, then ``Trainer.save``: ``gen_0000`` and
    ``gen_ema_0000`` unflattened and applied with flax equal the port's
    generator (and its EMA copy) on one input."""
    tc = tpipeline.TileCreator(recipe.synthetic_dataset(size=8, seed=4), 4,
                               density_threshold=0.0, device="cpu")
    tr = tloop.Trainer(_small_cfg(), tc, device="cpu")
    tr.fit(2, log_every=2)
    run = tckpt.next_run_dir(str(tmp_path))
    tr.save(run, 0, 2)
    x = np.random.default_rng(1).random((3, 6, 6, 4), dtype=np.float32)
    jg = JG.make_pass1(2, 8, 1)
    for prefix, weights in (("gen", None), ("gen_ema", tr.rt.ema)):
        flat, meta = convert.load_npz(tckpt.gen_path(run, 0, prefix))
        assert meta == {"pass_no": 1, "stage": 2, "up_res": 4}
        gen = tr.rt.gen
        if weights is not None:   # the EMA weights in a copy of G
            gen = TL.load_generator_npz(tckpt.gen_path(run, 0, prefix), 1,
                                        tr.cfg, "cpu")
            for k, p in gen.named_parameters():
                assert torch.equal(p, weights[k]), k
        want = np.asarray(jg.apply(_unflatten(flat), jnp.asarray(x)))
        with torch.no_grad():
            got = gen(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _cfg(test_path, use_ema=False):
    cfg = tconfig.Config()
    cfg.train.test_path = test_path
    cfg.model.n_base_filters = 8
    cfg.model.n_res_blocks = 1
    cfg.model.dtype = "float32"
    cfg.infer.use_ema = use_ema
    return cfg


def _save_jax(run, no, params, pass_no, stage, prefix="gen",
              sidecar=True):
    """JAX params written as the port's gen save, with a model sidecar."""
    os.makedirs(os.path.join(run, f"{prefix}_{no:04d}"), exist_ok=True)
    convert.save_npz(tckpt.gen_path(run, no, prefix),
                     jax.tree.map(np.asarray, params),
                     {"pass_no": pass_no, "stage": stage, "up_res": 4})
    if sidecar:
        os.makedirs(tckpt.model_dir(run, no), exist_ok=True)
        tckpt.write_json(tckpt.model_dir(run, no) + ".json",
                         {"it": 10, "stage": stage, "pass_no": pass_no})


LOADS = {  # name: (pass, saved stage, use_ema, EMA saved)
    "pass1_full": (1, 2, False, False),
    "pass1_mid_growth": (1, 1, False, False),
    "pass2_use_ema": (2, 2, True, True),
    "pass2_use_ema_fallback": (2, 2, True, False),
    "pass3": (3, 1, False, False),
}


@pytest.mark.parametrize("name", sorted(LOADS))
def test_load_generator_from_run_dir_matches_jax(tmp_path, name):
    """``load_generator(cfg, p, -1, -1)`` finds the newest run and
    checkpoint, rebuilds the sidecar's stage, prefers the EMA weights under
    ``useEma`` and falls back to ``gen_`` without them."""
    pass_no, stage, use_ema, with_ema = LOADS[name]
    base = str(tmp_path)
    tckpt.next_run_dir(base)                  # an older, empty run
    run = tckpt.next_run_dir(base)
    jg, hw = {1: (JG.make_pass1(stage, 8, 1), (6, 6)),
              2: (JG.make_pass2(stage, 8, 1), (6, 24)),
              3: (JG.make_pass3(8, 1), (24, 24))}[pass_no]
    x = np.random.default_rng(2).random((2, *hw, 4), dtype=np.float32)
    params = jg.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 4)))
    _save_jax(run, 0, jg.init(jax.random.PRNGKey(5), jnp.zeros((1, *hw, 4))),
              pass_no, stage)
    want_params = params
    _save_jax(run, 3, params, pass_no, stage)
    if with_ema:
        ema = jg.init(jax.random.PRNGKey(7), jnp.zeros((1, *hw, 4)))
        _save_jax(run, 3, ema, pass_no, stage, prefix="gen_ema",
                  sidecar=False)
        want_params = ema
    gen = TL.load_generator(_cfg(base, use_ema), pass_no, -1, -1, "cpu")
    if pass_no != 3:
        assert len(gen.factors) == stage
    want = np.asarray(jg.apply(want_params, jnp.asarray(x)))
    with torch.no_grad():
        got = gen(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_load_generator_discovery_errors_and_gen_only_runs(tmp_path):
    base = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="no test_%04d runs"):
        TL.load_generator(_cfg(base), 1, -1, -1, "cpu")
    run = tckpt.next_run_dir(base)
    with pytest.raises(FileNotFoundError, match="no saved checkpoints"):
        TL.load_generator(_cfg(base), 1, 0, -1, "cpu")
    # a gen-only run (no model_%04d): the newest gen_%04d, stage from its
    # own sidecar
    jg = JG.make_pass1(1, 8, 1)
    params = jg.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 6, 4)))
    _save_jax(run, 2, params, 1, 1, sidecar=False)
    gen = TL.load_generator(_cfg(base), 1, 0, -1, "cpu")
    assert gen.factors == ((2, 2),)
    with pytest.raises(ValueError, match="pass-1 generator"):
        TL.load_generator(_cfg(base), 2, 0, 2, "cpu")
