"""One train step of the port vs one of the JAX package, from equal weights
on one injected batch (CPU, float32, TF32 off): the flagship recipe (hinge,
lazy R1 every 16 steps, EMA 0.999, temporal D) at step 0, where R1 is
applied, and at step 1, where it is skipped. The other configurations are
in tests/test_torch_train_variants.py, which reuses :func:`step_pair`.

The JAX side runs its own Trainer and jitted step; pytest's monkeypatch
replaces ``mpgan_tpu.train.loop.make_sampler`` so that both of its batches
are the injected one. The port's ``TrainStep.sample`` returns the same
batch. Learning rates and Adam's ε are 1, so an Adam update is
g/(|g|+1): a smooth function of the gradient, and a tiny gradient whose
sign differs between the two runs cannot flip a parameter by 2·lr.

Tolerances: metrics rtol 1e-4 (losses after a D update, through several
convolutions summed in another order); parameters atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import config as tconfig
from mpgan_torch import convert
from mpgan_torch.data import pipeline as tpipeline
from mpgan_torch.train import loop as tloop
from mpgan_torch.train import recipe
from mpgan_tpu import config as jconfig
from mpgan_tpu.data import loader as jloader
from mpgan_tpu.data import pipeline as jpipeline
from mpgan_tpu.train import loop as jloop

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core oversubscribes the CPU
torch.set_num_threads(1)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

METRIC_RTOL = 1e-4
PARAM_ATOL = 1e-5
METRICS = ("d_loss", "dt_loss", "g_loss", "g_adv", "l1", "feat", "g_t",
           "psnr")


def small_config(**loss_kw) -> tconfig.Config:
    """The flagship recipe cut to test size: LR tile 4, base 8, 1 res
    block, disc base 8, B = 2, float32; learning rates and ε of 1."""
    cfg = recipe.flagship_config("float32", batch=2, tile=4)
    cfg.model.n_base_filters = 8
    cfg.model.n_res_blocks = 1
    cfg.model.disc_base_filters = 8
    cfg.train.learning_rate = cfg.train.lr_disc = 1.0
    cfg.train.adam_eps = 1.0
    for k, v in loss_kw.items():
        setattr(cfg.loss, k, v)
    return cfg


def jax_config(cfg: tconfig.Config) -> jconfig.Config:
    return jconfig.Config(
        data=jconfig.DataConfig(**dataclasses.asdict(cfg.data)),
        model=jconfig.ModelConfig(**dataclasses.asdict(cfg.model)),
        loss=jconfig.LossConfig(**dataclasses.asdict(cfg.loss)),
        train=jconfig.TrainConfig(**dataclasses.asdict(cfg.train)))


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _sd(tree) -> dict:
    return convert.flax_to_state_dict(_np_tree(tree))


def _close_sd(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {k}")


# JAX runtimes by (config, pass, seed): the jitted step takes the step
# counter as a traced value, so one compile serves every step number
_JAX_RUNTIMES: dict = {}


def _jax_runtime(monkeypatch, cfg, pass_no, seed, ds, batch):
    """The JAX Trainer's stage runtime, its step built while
    ``make_sampler`` is patched to hand out ``batch``."""
    key = (repr(cfg), pass_no, seed)
    if key not in _JAX_RUNTIMES:
        jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        with monkeypatch.context() as m:
            m.setattr(jloop, "make_sampler",
                      lambda *a, **k: (lambda data, key: jbatch))
            jds = jloader.FluidDataset(lr=ds.lr, hr=ds.hr, n_sims=ds.n_sims,
                                       n_frames=ds.n_frames,
                                       up_res=ds.up_res)
            jtc = jpipeline.TileCreator(jds, cfg.data.tile_size_low,
                                        density_threshold=0.0)
            jtr = jloop.Trainer(jax_config(cfg), jtc, pass_no=pass_no)
            # the JAX trainer's stage count: 1 for the pass-3 refiner
            jrt = jtr._init_stage(jtr.n_stages,
                                  jax.random.PRNGKey(seed), None)
        _JAX_RUNTIMES[key] = (jtr, jrt)
    return _JAX_RUNTIMES[key]


def injected_pair(monkeypatch, cfg: tconfig.Config, pass_no: int = 1,
                  seed: int = 0):
    """One batch drawn by the port's tile creator, the JAX Trainer and
    stage runtime whose step samples it, and a port Trainer with the JAX
    runtime's initial G, Ds, Dt and EMA → (batch, jtr, jrt, port
    Trainer)."""
    ds = recipe.synthetic_dataset(size=8, up=4, seed=seed)
    ttc = tpipeline.TileCreator(ds, cfg.data.tile_size_low,
                                density_threshold=0.0, device="cpu")
    temporal = cfg.train.use_temporal_disc
    sample = {1: ttc.sample_pass1, 2: ttc.sample_pass2,
              3: ttc.sample_pass3}[pass_no]
    batch = sample(torch.Generator().manual_seed(seed), cfg.train.batch_size,
                   temporal)
    jtr, jrt = _jax_runtime(monkeypatch, cfg, pass_no, seed, ds, batch)
    ttr = tloop.Trainer(cfg, ttc, device="cpu", pass_no=pass_no)
    rt = ttr.runtime()
    rt.gen.load_state_dict(_sd(jrt.state.params_g))
    rt.ds.load_state_dict(_sd(jrt.state.params_ds))
    if jrt.state.params_dt:
        rt.dt.load_state_dict(_sd(jrt.state.params_dt))
    if jrt.ema:
        for k, v in _sd(jrt.ema).items():
            rt.ema[k].copy_(v)
    return batch, jtr, jrt, ttr


def jax_steps(jtr, jrt, step: int, n: int = 1):
    """``n`` JAX steps from the runtime's initial state at step counter
    ``step`` → (state, EMA, metrics of the last)."""
    # the step donates its state and EMA: hand it copies, as the runtime
    # is reused
    state = jloop.copy_tree(jrt.state)._replace(step=jnp.int32(step))
    ema = jloop.copy_tree(jrt.ema)
    for _ in range(n):
        state, ema, jm = jrt.step_stable(state, ema, jtr._data(),
                                         jax.random.PRNGKey(1),
                                         jnp.ones((1,), jnp.float32))
    return state, ema, jm


def close_to_jax(rt, state, ema):
    """The port runtime's G, Ds, Dt and EMA against a JAX state."""
    _close_sd(rt.gen.state_dict(), _sd(state.params_g), "G")
    _close_sd(rt.ds.state_dict(), _sd(state.params_ds), "Ds")
    if state.params_dt:
        _close_sd(rt.dt.state_dict(), _sd(state.params_dt), "Dt")
    if ema:
        _close_sd(rt.ema, _sd(ema), "EMA")


def step_pair(monkeypatch, cfg: tconfig.Config, pass_no: int = 1,
              step: int = 0, seed: int = 0):
    """Run one step of each side from equal weights on one batch and
    compare metrics and the updated G, Ds, Dt and EMA parameters."""
    batch, jtr, jrt, ttr = injected_pair(monkeypatch, cfg, pass_no, seed)
    state, ema, jm = jax_steps(jtr, jrt, step)

    # port: the same weights, the same batch
    rt = ttr.rt
    rt.step = step
    rt.step_stable.sample = lambda rng: batch
    tm = tloop.read_metrics(rt.step_stable(1.0, torch.Generator()))

    for k in METRICS:
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=METRIC_RTOL,
                                   atol=1e-6, err_msg=k)
    close_to_jax(rt, state, ema)
    assert rt.step == step + 1
    return tm, {k: float(v) for k, v in jm.items()}, rt


@pytest.mark.parametrize("step", [0, 1], ids=["r1_applied", "r1_skipped"])
def test_flagship_step_matches_jax(monkeypatch, step):
    tm, jm, _ = step_pair(monkeypatch, small_config(), step=step)
    assert tm["dt_loss"] != 0.0 and tm["g_t"] != 0.0


def test_lazy_r1_branch_is_live(monkeypatch):
    """Step 16 applies R1 and step 17 skips it: the D loss differs between
    them (and each matches JAX)."""
    on, _, _ = step_pair(monkeypatch, small_config(), step=16)
    off, _, _ = step_pair(monkeypatch, small_config(), step=17)
    assert on["d_loss"] != off["d_loss"]
