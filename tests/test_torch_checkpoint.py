"""Checkpoint and resume of the port (CPU, float32).

- The run-dir discovery helpers of ``mpgan_torch.train.checkpoint`` give
  exactly the answers of ``mpgan_tpu.train.checkpoint`` on the same trees
  (the cases of ``tests/test_train.py``'s resume tests, and more).
- ``Trainer.save`` then ``Trainer.restore`` in a new Trainer brings back
  every tensor of G, Ds, Dt, the three optimizers, the EMA, the step and
  the growth stage, bit for bit; saves overwrite; a cross-pass or corrupt
  sidecar raises ``ValueError``; two resumes of one checkpoint are
  bit-equal.
- A port step, a save, a restore into a fresh Trainer and a second step
  equal two JAX steps from equal weights on one injected batch (the method
  and tolerances of ``tests/test_torch_train_step.py``), so Adam's moments
  and its bias-correction count carry across a resume.
"""

import json
import os

import pytest
import torch

from mpgan_torch.data import pipeline as tpipeline
from mpgan_torch.train import checkpoint as tckpt
from mpgan_torch.train import loop as tloop
from mpgan_torch.train import recipe
from mpgan_tpu.train import checkpoint as jckpt
from test_torch_train_step import (close_to_jax, injected_pair, jax_steps,
                                   small_config)

torch.set_num_threads(1)


# ------------------------------------------------------------ discovery

def _tree(base, runs):
    """Run dirs under ``base``, one per entry: ``models`` maps a number to
    its sidecar (a dict, None for none, "corrupt"), ``gens`` lists
    gen-only numbers, ``params`` is the pass params.json records (None: no
    file, "old": a file without the field)."""
    for spec in runs:
        run = tckpt.next_run_dir(base)
        for no, meta in spec.get("models", {}).items():
            os.makedirs(tckpt.model_dir(run, no))
            if meta == "corrupt":
                with open(tckpt.model_dir(run, no) + ".json", "w") as f:
                    f.write('{"pass_no": 1, "it"')
            elif meta is not None:
                with open(tckpt.model_dir(run, no) + ".json", "w") as f:
                    json.dump(meta, f)
        for no in spec.get("gens", []):
            os.makedirs(tckpt.gen_dir(run, no))
        pno = spec.get("params")
        if pno is not None:
            log = {"argv": [], "config": {}}
            if pno != "old":
                log["pass_no"] = pno
            with open(os.path.join(run, "params.json"), "w") as f:
                json.dump(log, f)


def _p(pass_no, it=100, **kw):
    return {"pass_no": pass_no, "it": it, **kw}


TREES = {
    "empty": [],
    "newest_same_pass": [{"models": {0: _p(1), 2: _p(1)}, "params": 1},
                         {"models": {1: _p(2)}, "params": 2},
                         {"params": 1}],
    "min_index_scope": [{"models": {0: _p(1), 5: _p(1)}},
                        {"models": {1: _p(1)}}],
    "sidecarless": [{"models": {0: _p(1), 1: None}}],
    "corrupt_sidecar": [{"models": {0: _p(1), 1: "corrupt"}},
                        {"models": {0: _p(2)}, "params": 2}],
    "recover_dead_runs": [{"params": 1},
                          {"params": 2, "models": {0: None}},
                          {"params": 1, "gens": [0]},
                          {"params": "old"}],
    "dead_newest": [{"models": {0: _p(1, total_iters=4)}, "params": 1},
                    {"params": 1}],
    "gen_only_and_pass3": [{"gens": [0, 3]},
                           {"models": {2: _p(3), 7: _p(3)}, "params": 3}],
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_discovery_helpers_equal_jax(tmp_path, name):
    base = str(tmp_path / "runs")
    _tree(base, TREES[name])
    got, want = [], []
    for mod, out in ((tckpt, got), (jckpt, want)):
        out.append(mod.latest_run_idx(base))
        for idx in range(len(TREES[name]) + 1):
            run = mod.run_dir(base, idx)
            out.append((mod.latest_model_no(run), mod.latest_gen_no(run),
                        mod.run_pass_no(run)))
        for pass_no in (None, 1, 2, 3):
            for lo in (-1, 0, 1, 2):
                for hi in (None, 0, 1, 3):
                    out.append(mod.latest_resumable(base, pass_no, lo, hi))
        for pass_no in (1, 2, 3):
            for lo in (-1, 1, 3):
                out.append(mod.recover_run_dir(base, pass_no, min_index=lo))
    assert got == want
    run = tckpt.next_run_dir(base)   # the next index, as JAX's would pick
    assert os.path.basename(run) == f"test_{len(TREES[name]):04d}"


# ------------------------------------------------------------ round trip

def _cfg(**train_kw):
    cfg = recipe.flagship_config("float32", batch=2, tile=4)
    cfg.model.n_base_filters = 8
    cfg.model.n_res_blocks = 1
    cfg.model.disc_base_filters = 8
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


def _tc():
    return tpipeline.TileCreator(recipe.synthetic_dataset(size=8, seed=3), 4,
                                 density_threshold=0.0, device="cpu")


GROWING = dict(use_growing=True, alpha_iters=2, stable_iters=2)


def _tensors(tr) -> dict:
    """Every tensor of a trainer's state, flattened, with the step and the
    stage."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}/{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}/{i}", v)
        else:
            out[prefix] = x
    walk("", tr.state())
    out["stage"] = tr.rt.stage
    return out


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k, v in a.items():
        if torch.is_tensor(v):
            assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def test_save_restore_round_trip_is_bit_equal(tmp_path):
    """fit(2) of a growing run (still at stage 1), save, restore into a new
    Trainer: every tensor equal, Adam's moments and counts included."""
    tr = tloop.Trainer(_cfg(**GROWING), _tc(), device="cpu")
    tr.fit(2, log_every=2)
    assert tr.rt.stage == 1 and tr.rt.opt_g.state
    run = tckpt.next_run_dir(str(tmp_path))
    tr.save(run, 1, 2, total_iters=6)
    tr.save(run, 1, 2, total_iters=6)           # overwriting is safe
    assert tckpt.read_json(tckpt.model_dir(run, 1) + ".json") == {
        "it": 2, "stage": 1, "pass_no": 1, "up_res": 4, "total_iters": 6}
    assert not any(f.endswith(".tmp") for f in os.listdir(run))
    tr2 = tloop.Trainer(_cfg(**GROWING), _tc(), device="cpu")
    assert tr2.restore(run, 1) == 2
    _equal(_tensors(tr2), _tensors(tr))
    assert tr2.rt.step == 2 and tr2.rt.gen.factors == ((2, 2),)


def test_restore_refuses_other_pass_and_corrupt_sidecar(tmp_path):
    tr = tloop.Trainer(_cfg(), _tc(), device="cpu")
    tr.fit(1, log_every=1)
    run = tckpt.next_run_dir(str(tmp_path))
    tr.save(run, 0, 1)
    with pytest.raises(ValueError, match="training pass 1"):
        tloop.Trainer(_cfg(), _tc(), device="cpu", pass_no=2).restore(run, 0)
    with open(tckpt.model_dir(run, 0) + ".json", "w") as f:
        f.write('{"it": 1, "sta')
    with pytest.raises(ValueError, match="corrupt"):
        tloop.Trainer(_cfg(), _tc(), device="cpu").restore(run, 0)


def test_restore_without_ema_restarts_it_from_the_params(tmp_path):
    tr = tloop.Trainer(_cfg(ema_decay=0.0), _tc(), device="cpu")
    tr.fit(1, log_every=1)
    run = tckpt.next_run_dir(str(tmp_path))
    tr.save(run, 0, 1)
    assert not os.path.exists(tckpt.gen_dir(run, 0, "gen_ema"))
    tr2 = tloop.Trainer(_cfg(), _tc(), device="cpu")
    tr2.restore(run, 0)
    for k, p in tr2.rt.gen.named_parameters():
        assert torch.equal(tr2.rt.ema[k], p.detach()), k


def test_two_resumes_of_one_checkpoint_are_bit_equal(tmp_path):
    """Resumed at iteration 2, each fit to 6 across the growth boundary at
    4: the sampling stream is a function of (randSeed, start_it)."""
    tr = tloop.Trainer(_cfg(**GROWING), _tc(), device="cpu")
    seen = []
    run = tckpt.next_run_dir(str(tmp_path))

    def on_checkpoint(trainer, it):
        seen.append(it)
        trainer.save(run, it // 2, it)
    tr.cfg.train.save_interval = 2
    tr.fit(4, log_every=4, on_checkpoint=on_checkpoint)
    assert seen == [2]                        # every 2 iterations, not at 4
    runs = []
    for _ in range(2):
        t = tloop.Trainer(_cfg(**GROWING), _tc(), device="cpu")
        out = t.fit(6, log_every=6, start_it=t.restore(run, 1))
        runs.append((out, _tensors(t)))
    (a, ta), (b, tb) = runs
    assert ta["stage"] == 2
    _equal(ta, tb)
    for k in ("d_loss", "dt_loss", "g_loss"):
        assert a[k] == b[k], k


def test_resume_matches_two_jax_steps(monkeypatch, tmp_path):
    """Port: a step (R1 applied at step 0), save, restore into a fresh
    Trainer, a second step (R1 skipped at step 1) on the same batch. JAX:
    two steps from the same weights. Equal G, Ds, Dt and EMA.

    ``lrdisc`` 1e-2: at 1, the first step moves D so far that its float32
    noise reaches the second G update at 1e-3, with or without a resume
    between the steps; at 1e-2 the two steps in one process stay within
    7.7e-6 of JAX's. A resume that lost Adam's count would take the
    first step's bias correction again, off by a third of the update."""
    cfg = small_config()
    cfg.train.lr_disc = 1e-2
    batch, jtr, jrt, ttr = injected_pair(monkeypatch, cfg)
    state, ema, _ = jax_steps(jtr, jrt, 0, n=2)

    ttr.rt.step_stable.sample = lambda rng: batch
    ttr.rt.step_stable(1.0, torch.Generator())
    run = tckpt.next_run_dir(str(tmp_path))
    ttr.save(run, 0, 1)
    fresh = tloop.Trainer(cfg, ttr.tc, device="cpu")
    assert fresh.restore(run, 0) == 1 and fresh.rt.step == 1
    fresh.rt.step_stable.sample = lambda rng: batch
    fresh.rt.step_stable(1.0, torch.Generator())
    close_to_jax(fresh.rt, state, ema)
    assert fresh.rt.step == 2
    assert all(float(s["step"]) == 2.0
               for s in fresh.rt.opt_g.state.values())
